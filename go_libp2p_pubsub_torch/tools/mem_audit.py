"""Per-buffer resident-memory audit of every model family's state (r22).

Usage (``M = python -m go_libp2p_pubsub_torch.tools.mem_audit``)::

    M                                          # human-readable tables
    M --json                                   # one JSON document
    M --peers 16384 --compile
    M --models gossipsub,rlnc --peers 512 --json
    M --device cpu --json                      # on the CPU

Walks the REAL initialized state of each model family (GossipSub,
MultiTopic, Hybrid, RLNC — the sharded path shares GossipState leaf for
leaf, so its per-device budget is the gossipsub rows divided by the shard
count), records every buffer's exact shape/dtype/bytes, and groups them by
plane (index / mesh / score / promise / window / decode / liveness / misc).
The buffers read in the reference's dtypes (``bridge.py``'s spec
functions): the port stores the packed windows and the keys as int32 bit
patterns of the reference's uint32, and its round counter on the host.
One real ``step`` of the model on ``--device`` asserts the carry keeps
the SAME structure — what init allocates is what stays resident through a
rollout, narrow index dtypes included.

Each family is audited twice — narrow index storage (the r22 default) vs
the legacy int32 planes (``index_dtype_override=np.int32``) — and the
index-plane reduction is reported as the standing acceptance metric.

Per-peer costs extrapolate to the million-peer target exactly: buffers with
a leading peer dim scale linearly, fixed buffers carry over, and the index
planes are re-derived per target N from ``index_dtype`` (nbrs switches to
int32 above 65534 peers; rev stays uint16 — its domain is the slot count).

``--compile`` additionally reads the card's own allocator on the
gossipsub narrow arm (it needs a CUDA ``--device``): the rise of
``torch.cuda.memory_allocated`` over ``init`` (the resident state) and,
over an 8-step ``rollout(record=False)``, the rise of
``torch.cuda.max_memory_allocated`` above what was allocated when it
started (the rollout's temporaries).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import bridge
from . import device_error

# Field-name -> plane grouping.  By NAME (the gossip_sharded.py convention):
# an unclassified field lands in "misc" rather than crashing, and the test
# suite pins the classification of every current state field.
PLANE_BY_FIELD: Dict[str, str] = {
    # index planes (the r22 narrow-storage targets: integer peer/slot ids)
    "nbrs": "index", "rev": "index",
    # boolean adjacency masks over the same [N, K] slots (dtype-fixed)
    "nbr_valid": "adjacency", "outbound": "adjacency",
    "nbr_sub": "adjacency", "edge_live": "adjacency",
    # mesh maintenance
    "mesh": "mesh", "fanout": "mesh", "fanout_age": "mesh",
    "backoff": "mesh",
    # scoring
    "counters": "score", "gcounters": "score", "scores": "score",
    # promise/gossip bookkeeping
    "gossip_pend_w": "promise", "iwant_pend_w": "promise",
    "gossip_mute": "promise", "self_promo": "promise",
    "gossip_delay": "promise", "pend_hold": "promise",
    "edge_delay": "promise",
    # message window / delivery receipts
    "have_w": "window", "fresh_w": "window", "fresh_hist": "window",
    "have": "window", "fresh": "window",
    "first_step": "window", "msg_valid": "window", "msg_birth": "window",
    "msg_active": "window", "msg_used": "window",
    # coded/decode plane (rlnc + hybrid)
    "basis": "decode", "loss_ewma": "decode", "coded": "decode",
    "ingress_loss": "decode", "ingress_loss_p": "decode",
    "key_coded": "decode", "key_loss": "decode",
    # liveness / membership
    "alive": "liveness", "subscribed": "liveness", "silenced": "liveness",
    # everything else
    "key": "misc", "step": "misc",
}

PLANES = ("index", "adjacency", "mesh", "score", "promise", "window",
          "decode", "liveness", "misc")


def walk_state(state: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield ``(dotted.path, leaf)`` over a NamedTuple state pytree."""
    if hasattr(state, "_fields"):  # NamedTuple (GossipState, counters, ...)
        for name in state._fields:
            yield from walk_state(
                getattr(state, name), f"{prefix}{name}." if True else name
            )
    elif isinstance(state, dict):
        for name in sorted(state):
            yield from walk_state(state[name], f"{prefix}{name}.")
    elif isinstance(state, (list, tuple)):
        for i, item in enumerate(state):
            yield from walk_state(item, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), state


def audit_state(st: Any, n_peers: int) -> Dict[str, Any]:
    """Exact per-buffer bytes of one initialized state -> audit dict."""
    buffers: List[Dict[str, Any]] = []
    for path, leaf in walk_state(st):
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = np.dtype(getattr(leaf, "dtype", np.float32))
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
        field = path.split(".")[-1]
        buffers.append({
            "buffer": path,
            "plane": PLANE_BY_FIELD.get(field, "misc"),
            "shape": list(shape),
            "dtype": str(dtype),
            "bytes": nbytes,
            "peer_scaled": bool(shape) and shape[0] == n_peers,
        })
    plane_bytes = {p: 0 for p in PLANES}
    for b in buffers:
        plane_bytes[b["plane"]] += b["bytes"]
    total = sum(b["bytes"] for b in buffers)
    peer_bytes = sum(b["bytes"] for b in buffers if b["peer_scaled"])
    fixed_bytes = total - peer_bytes
    return {
        "n_peers": n_peers,
        "buffers": buffers,
        "plane_bytes": plane_bytes,
        "total_bytes": total,
        "peer_scaled_bytes": peer_bytes,
        "fixed_bytes": fixed_bytes,
        "bytes_per_peer": round(peer_bytes / max(n_peers, 1), 2),
    }


def _index_plane_bytes_at(n: int, k: int, narrow: bool) -> int:
    """Exact nbrs+rev storage bytes at N peers, K slots — re-deriving the
    dtype per N (the extrapolation must not assume the audited N's dtype)."""
    from ..ops.graphs import index_dtype

    if narrow:
        return n * k * (index_dtype(n).itemsize + index_dtype(k).itemsize)
    return n * k * (4 + 4)


def extrapolate(audit: Dict[str, Any], k_slots: int, targets: List[int],
                narrow: bool) -> Dict[str, Any]:
    """Project the audited budget to larger peer counts.

    Non-index peer-scaled buffers scale linearly (dtype-independent);
    nbrs/rev are re-derived exactly per target so the uint16 -> int32
    switch above 65534 peers is reflected instead of linearly understated.
    """
    n0 = audit["n_peers"]
    nbrs_rev_now = sum(
        b["bytes"] for b in audit["buffers"]
        if b["buffer"].split(".")[-1] in ("nbrs", "rev")
    )
    other_peer = audit["peer_scaled_bytes"] - nbrs_rev_now
    out = {}
    for n in targets:
        idx = _index_plane_bytes_at(n, k_slots, narrow)
        total = int(other_peer / max(n0, 1) * n + audit["fixed_bytes"] + idx)
        out[str(n)] = {
            "total_bytes": total,
            "index_plane_bytes": idx,
            "bytes_per_peer": round(total / n, 2),
        }
    return out


def build_model(name: str, n_peers: int, n_slots: int, degree: int,
                msg_window: int, override, device="cuda"):
    from ..models.gossipsub import GossipSub
    from ..models.hybrid import HybridGossipSub
    from ..models.multitopic import MultiTopicGossipSub
    from ..models.rlnc import RLNC

    common = dict(n_peers=n_peers, n_slots=n_slots, conn_degree=degree,
                  msg_window=msg_window, index_dtype_override=override,
                  device=device)
    if name == "gossipsub":
        return GossipSub(heartbeat_steps=4, **common)
    if name == "multitopic":
        return MultiTopicGossipSub(n_topics=2, heartbeat_steps=4, **common)
    if name == "hybrid":
        return HybridGossipSub(heartbeat_steps=4, gen_size=4, **common)
    if name == "rlnc":
        return RLNC(gen_size=4, **common)
    raise ValueError(f"unknown model family: {name}")


# Each family's state -> its numpy form's shapes and dtypes (the
# reference's), without reading the device.
STATE_SPEC = {
    "gossipsub": bridge.state_spec,
    "multitopic": bridge.multitopic_state_spec,
    "hybrid": bridge.hybrid_state_spec,
    "rlnc": bridge.rlnc_state_spec,
}


def _carried(leaf) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype) of a state leaf as the port holds it (the round
    counter is a host int)."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype)
    return (), type(leaf).__name__


def audit_model(name: str, n_peers: int, n_slots: int, degree: int,
                msg_window: int, targets: List[int],
                compile_rollout: bool, device="cuda") -> Dict[str, Any]:
    """Audit one family narrow-vs-wide + carry check + extrapolation."""
    out: Dict[str, Any] = {"family": name}
    audits = {}
    for arm, override in (("narrow", None), ("int32", np.int32)):
        model = build_model(name, n_peers, n_slots, degree, msg_window,
                           override, device)
        card = compile_rollout and name == "gossipsub" and arm == "narrow"
        if card:
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
        st = model.init(0)
        if card:
            torch.cuda.synchronize(device)
            resident = torch.cuda.memory_allocated(device) - before
        a = audit_state(STATE_SPEC[name](st), n_peers)
        # The rollout carry is exactly the state: one real step of the
        # public ``step`` on the device, and every buffer keeps its shape
        # AND dtype — the narrow planes stay narrow while resident.
        stepped = model.step(st)
        for (pa, la), (pb, lb) in zip(walk_state(st), walk_state(stepped)):
            assert pa == pb and _carried(la) == _carried(lb), (
                f"{name}/{arm}: step changes resident buffer {pa}: "
                f"{_carried(la)} -> {_carried(lb)}"
            )
        del stepped
        a["extrapolated"] = extrapolate(
            a, n_slots, targets, narrow=override is None
        )
        audits[arm] = a
        if card:
            steps = 8
            torch.cuda.synchronize(device)
            start = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            model.rollout(st, steps, record=False)
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
            out["rollout_memory"] = {
                "rollout_steps": steps,
                "init_allocated_rise_bytes": int(resident),
                "rollout_peak_rise_bytes": int(peak - start),
            }
    narrow_idx = audits["narrow"]["plane_bytes"]["index"]
    wide_idx = audits["int32"]["plane_bytes"]["index"]
    nbrs_rev_narrow = sum(
        b["bytes"] for b in audits["narrow"]["buffers"]
        if b["buffer"].split(".")[-1] in ("nbrs", "rev")
    )
    nbrs_rev_wide = sum(
        b["bytes"] for b in audits["int32"]["buffers"]
        if b["buffer"].split(".")[-1] in ("nbrs", "rev")
    )
    out.update({
        "narrow": audits["narrow"],
        "int32": audits["int32"],
        "index_plane_reduction": round(
            1.0 - narrow_idx / max(wide_idx, 1), 4
        ),
        "nbrs_rev_reduction": round(
            1.0 - nbrs_rev_narrow / max(nbrs_rev_wide, 1), 4
        ),
        "total_reduction": round(
            1.0 - audits["narrow"]["total_bytes"]
            / max(audits["int32"]["total_bytes"], 1), 4
        ),
    })
    return out


def run_audit(models: List[str], n_peers: int, n_slots: int, degree: int,
              msg_window: int, targets: List[int],
              compile_rollout: bool, device="cuda") -> Dict[str, Any]:
    return {
        "metric": "mem_audit",
        "n_peers": n_peers,
        "n_slots": n_slots,
        "conn_degree": degree,
        "msg_window": msg_window,
        "extrapolation_targets": targets,
        "models": {
            name: audit_model(name, n_peers, n_slots, degree, msg_window,
                              targets, compile_rollout, device)
            for name in models
        },
    }


def _fmt_bytes(b: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b} B"
        b /= 1024
    return f"{b} B"


def print_human(doc: Dict[str, Any]) -> None:
    print(f"memory audit @ {doc['n_peers']} peers, {doc['n_slots']} slots, "
          f"degree {doc['conn_degree']}, window {doc['msg_window']}")
    for name, m in doc["models"].items():
        na, wa = m["narrow"], m["int32"]
        print(f"\n== {name} ==  total {_fmt_bytes(na['total_bytes'])} "
              f"(int32 planes: {_fmt_bytes(wa['total_bytes'])}; "
              f"index-plane reduction "
              f"{m['index_plane_reduction'] * 100:.1f}%, "
              f"nbrs+rev {m['nbrs_rev_reduction'] * 100:.1f}%)")
        print(f"{'plane':<10} {'narrow':>12} {'int32':>12}")
        for p in PLANES:
            if na["plane_bytes"][p] == 0 and wa["plane_bytes"][p] == 0:
                continue
            print(f"{p:<10} {_fmt_bytes(na['plane_bytes'][p]):>12} "
                  f"{_fmt_bytes(wa['plane_bytes'][p]):>12}")
        print(f"bytes/peer {na['bytes_per_peer']} "
              f"(int32 {wa['bytes_per_peer']})")
        for n, e in na["extrapolated"].items():
            print(f"  @{int(n):>9,} peers: {_fmt_bytes(e['total_bytes'])} "
                  f"(index planes {_fmt_bytes(e['index_plane_bytes'])}, "
                  f"{e['bytes_per_peer']} B/peer)")
        if "rollout_memory" in m:
            rm = m["rollout_memory"]
            print(f"  on the card: init allocated "
                  f"{_fmt_bytes(rm['init_allocated_rise_bytes'])}, "
                  f"rollout ({rm['rollout_steps']} steps) peak above its "
                  f"start {_fmt_bytes(rm['rollout_peak_rise_bytes'])}")


DEFAULT_MODELS = ["gossipsub", "multitopic", "hybrid", "rlnc"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of tables")
    ap.add_argument("--peers", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--models", default=",".join(DEFAULT_MODELS),
                    help="comma-separated family subset")
    ap.add_argument("--extrapolate", default="65534,204800,1000000",
                    help="comma-separated peer-count targets")
    ap.add_argument("--compile", action="store_true",
                    help="also read the card's allocator over the gossipsub "
                         "init and an 8-step rollout (CUDA devices only)")
    ap.add_argument("--device", default="cuda",
                    help="where the models are built and stepped (default "
                         "cuda; cpu runs them on the CPU)")
    args = ap.parse_args(argv)
    err = device_error(args.device)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.compile and torch.device(args.device).type != "cuda":
        ap.error("--compile reads the card's allocator: it needs a CUDA "
                 "--device")

    models = [m.strip() for m in args.models.split(",") if m.strip()]
    unknown = set(models) - set(DEFAULT_MODELS)
    if unknown:
        ap.error(f"unknown model families: {sorted(unknown)}")
    targets = [int(t) for t in args.extrapolate.split(",") if t.strip()]
    doc = run_audit(models, args.peers, args.slots, args.degree,
                    args.window, targets, args.compile, args.device)
    if args.json:
        print(json.dumps(doc))
    else:
        print_human(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
