"""The PyTorch port's ops held against the JAX package's, on inputs made
with numpy from a seed: scoring, heartbeat mesh maintenance (both prologue
arms), PX, the latency histogram, and the two kernels' plain versions
against both the jnp reference and the Pallas kernels (interpret mode).

Every comparison is exact: integer, bool and packed results, and the f32
scores too -- mesh decisions threshold and sort on them, so a one-ulp
difference would fork a trajectory.  The JAX functions are jitted, as the
model runs them (XLA's CPU fusions round some float sums differently from
op-by-op execution, and the port reproduces the fused rounding).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.config import GossipSubParams as JP
from go_libp2p_pubsub_tpu.config import ScoreParams as JS
from go_libp2p_pubsub_tpu.models.gossipsub import build_topology
from go_libp2p_pubsub_tpu.ops import bitpack as jbp
from go_libp2p_pubsub_tpu.ops import gossip as jgossip
from go_libp2p_pubsub_tpu.ops import gossip_packed as jgp
from go_libp2p_pubsub_tpu.ops import histogram as jhist
from go_libp2p_pubsub_tpu.ops import px as jpx
from go_libp2p_pubsub_tpu.ops import scoring as jsc
from go_libp2p_pubsub_tpu.ops.graphs import decode_index_plane
from go_libp2p_pubsub_tpu.ops.pallas_gossip import (
    gossip_exchange_packed_pallas,
    propagate_packed_pallas,
)
from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch.ops import cuda_gossip
from go_libp2p_pubsub_torch.ops import gossip as tgossip
from go_libp2p_pubsub_torch.ops import gossip_packed as tgp
from go_libp2p_pubsub_torch.ops import histogram as thist
from go_libp2p_pubsub_torch.ops import px as tpx
from go_libp2p_pubsub_torch.ops import rng as trng
from go_libp2p_pubsub_torch.ops import scoring as tsc


def _t(a) -> torch.Tensor:
    """numpy/jax array -> torch tensor (uint32 words as int32 patterns)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _eq(out, ref, what=""):
    o = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    r = np.asarray(ref)
    if r.dtype == np.uint32:
        r = r.view(np.int32)
    if r.dtype == np.float32:  # bit for bit, NaN and -0.0 included
        o, r = o.view(np.int32), r.view(np.int32)
    assert o.shape == r.shape, (what, o.shape, r.shape)
    np.testing.assert_array_equal(o, r, err_msg=what)


def _keys(seed):
    return jax.random.PRNGKey(seed), trng.PRNGKey(seed)


def _graph(seed, n, k, degree=None):
    """Random slot-paired topology + a symmetric mesh, liveness and
    edge_live, as int32 index planes."""
    rng = np.random.default_rng(seed)
    degree = min(12, k - 1) if degree is None else degree
    nbrs, rev, valid, outbound = build_topology(rng, n, k, degree)
    nbrs = decode_index_plane(nbrs)
    rev = decode_index_plane(rev)
    j, r = np.clip(nbrs, 0, n - 1), np.clip(rev, 0, k - 1)
    mesh = valid & (rng.random((n, k)) < 0.6)
    mesh = mesh & mesh[j, r]
    alive = rng.random(n) < 0.9
    edge_live = valid & alive[j]
    return rng, dict(nbrs=nbrs, rev=rev, valid=valid, outbound=outbound,
                     mesh=mesh, alive=alive, edge_live=edge_live)


# -- scoring ----------------------------------------------------------------


def _counters(rng, n, k):
    """Counters with fractional values, as decays and mesh clocks make."""
    f = lambda scale: (rng.random((n, k)) * scale).astype(np.float32)  # noqa: E731
    return (f(40.0), f(30.0), f(40.0), f(5.0), f(6.0), f(12.0))


SCORE_PARAMS = [
    JS(),
    JS(mesh_message_deliveries_weight=-0.7, mesh_failure_penalty_weight=-0.3,
       invalid_message_deliveries_weight=-2.5, time_in_mesh_weight=0.0277,
       first_message_deliveries_weight=0.9, app_specific_weight=0.5,
       topic_weight=0.6, behaviour_penalty_weight=-1.5,
       ip_colocation_factor_threshold=2.0),
]


@pytest.mark.parametrize("pi", range(len(SCORE_PARAMS)))
def test_scoring_matches_reference(pi):
    jp = SCORE_PARAMS[pi]
    tp = bridge.params_from(jp)
    rng, g = _graph(11 + pi, 257, 16)
    n, k = g["nbrs"].shape
    raw = _counters(rng, n, k)
    jc = jsc.TopicCounters(*(jnp.asarray(x) for x in raw))
    tc = tsc.TopicCounters(*(_t(x) for x in raw))
    app = rng.normal(0, 2, n).astype(np.float32)
    grp = rng.integers(0, n // 8, n).astype(np.int32)
    bp = (rng.random(n) * 3).astype(np.float32)
    jg = jsc.GlobalCounters(jnp.asarray(app), jnp.asarray(grp), jnp.asarray(bp))
    tg = tsc.GlobalCounters(_t(app), _t(grp), _t(bp))
    nb, valid = g["nbrs"], g["valid"]

    _eq(tsc.topic_score(tc, tp), jax.jit(jsc.topic_score, static_argnums=1)(
        jc, jp), "topic_score")
    _eq(tsc.global_score(tg, tp), jax.jit(jsc.global_score, static_argnums=1)(
        jg, jp), "global_score")
    _eq(tsc.colocation_penalty(_t(grp), tp),
        jax.jit(jsc.colocation_penalty, static_argnums=1)(
            jnp.asarray(grp), jp), "colocation_penalty")
    ref = jax.jit(jsc.neighbor_scores, static_argnums=4)(
        jc, jg, jnp.asarray(nb), jnp.asarray(valid), jp)
    _eq(tsc.neighbor_scores(tc, tg, _t(nb), _t(valid), tp), ref, "scores")
    for jout, tout in (
        (jax.jit(jsc.decay_topic_counters, static_argnums=1)(jc, jp),
         tsc.decay_topic_counters(tc, tp)),
        (jax.jit(jsc.on_graft)(jc, jnp.asarray(g["mesh"])),
         tsc.on_graft(tc, _t(g["mesh"]))),
        (jax.jit(jsc.on_prune, static_argnums=2)(
            jc, jnp.asarray(g["mesh"]), jp),
         tsc.on_prune(tc, _t(g["mesh"]), tp)),
        (jax.jit(jsc.tick_mesh_clocks, static_argnums=2)(
            jc, jnp.asarray(g["mesh"]), 1.0),
         tsc.tick_mesh_clocks(tc, _t(g["mesh"]), 1.0)),
    ):
        for name, a, b in zip(jsc.TopicCounters._fields, tout, jout):
            _eq(a, b, name)
    _eq(tsc.decay_global_counters(tg, tp).behaviour_penalty,
        jax.jit(jsc.decay_global_counters, static_argnums=1)(
            jg, jp).behaviour_penalty, "decay_global")


# -- heartbeat mesh, PX ------------------------------------------------------


def _scores(rng, g):
    n, k = g["nbrs"].shape
    s = rng.normal(0.3, 1.0, (n, k)).astype(np.float32)
    return np.where(g["valid"], s, -np.inf).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("do_og", [False, True])
@pytest.mark.parametrize("extras", [False, True])
def test_heartbeat_mesh_matches_reference(fused, do_og, extras):
    """Both prologue arms, with and without the opportunistic tick, and
    with GRAFT spammers (``ignore_backoff``) and a renumbered draw
    (``uid``)."""
    rng, g = _graph(21, 300, 16, degree=14)
    n, k = g["nbrs"].shape
    scores = _scores(rng, g)
    backoff = rng.integers(0, 3, (n, k)).astype(np.int32)
    spam = rng.random(n) < 0.2 if extras else None
    uid = rng.permutation(n).astype(np.int32) if extras else None
    p = JP(d=6, d_lo=4, d_hi=8, d_score=3, d_out=2)
    jk, tk = _keys(5)
    nb, rv = g["nbrs"], g["rev"]
    edge_idx_j = (jnp.clip(jnp.asarray(nb), 0, n - 1),
                  jnp.clip(jnp.asarray(rv), 0, k - 1)) if fused else None
    edge_idx_t = (torch.clamp(_t(nb), 0, n - 1),
                  torch.clamp(_t(rv), 0, k - 1)) if fused else None

    def ref(key, mesh, sc, nb, rv, el, alive, bo, ob, og, ei, spam, uid):
        return jgossip.heartbeat_mesh(
            key, mesh, sc, nb, rv, el, alive, p, bo, ob, og,
            og_threshold=0.5, ignore_backoff=spam, uid=uid, edge_idx=ei,
            with_px_offer=fused)

    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    jout = jax.jit(ref)(
        jk, jnp.asarray(g["mesh"]), jnp.asarray(scores), jnp.asarray(nb),
        jnp.asarray(rv), jnp.asarray(g["edge_live"]), jnp.asarray(g["alive"]),
        jnp.asarray(backoff), jnp.asarray(g["outbound"]), jnp.asarray(do_og),
        edge_idx_j, opt(spam, jnp.asarray), opt(uid, jnp.asarray))
    tout = tgossip.heartbeat_mesh(
        tk, _t(g["mesh"]), _t(scores), _t(nb), _t(rv), _t(g["edge_live"]),
        _t(g["alive"]), bridge.params_from(p), _t(backoff),
        _t(g["outbound"]), do_og, og_threshold=0.5,
        ignore_backoff=opt(spam, _t), uid=opt(uid, _t), edge_idx=edge_idx_t,
        with_px_offer=fused)
    assert len(tout) == len(jout) == (6 if fused else 5)
    for i, (a, b) in enumerate(zip(tout, jout)):
        _eq(a, b, f"output {i}")


@pytest.mark.parametrize("with_offer", [False, True])
def test_px_rewire_matches_reference(with_offer):
    rng, g = _graph(31, 240, 16, degree=9)
    n, k = g["nbrs"].shape
    scores = (rng.normal(8.0, 6.0, (n, k))).astype(np.float32)
    pruned = g["mesh"] & (rng.random((n, k)) < 0.5)
    mesh_after = g["mesh"] & ~pruned
    backoff = rng.integers(0, 4, (n, k)).astype(np.int32)
    offer = rng.random((n, k)) < 0.8 if with_offer else None
    jk, tk = _keys(9)
    args_j = (jk, jnp.asarray(g["nbrs"]), jnp.asarray(g["rev"]),
              jnp.asarray(g["valid"]), jnp.asarray(g["outbound"]),
              jnp.asarray(backoff), jnp.asarray(mesh_after),
              jnp.asarray(pruned), jnp.asarray(scores),
              jnp.asarray(g["alive"]))
    ref = jax.jit(lambda *a, offer: jpx.px_rewire(*a, 5.0, offer_ok=offer))(
        *args_j, offer=None if offer is None else jnp.asarray(offer))
    out = tpx.px_rewire(
        tk, _t(g["nbrs"]), _t(g["rev"]), _t(g["valid"]), _t(g["outbound"]),
        _t(backoff), _t(mesh_after), _t(pruned), _t(scores), _t(g["alive"]),
        5.0, offer_ok=None if offer is None else _t(offer))
    assert int(np.asarray(ref.connected).sum()) > 0  # the case is exercised
    for name, a, b in zip(jpx.PxOut._fields, out, ref):
        _eq(a, b, name)


# -- histogram ----------------------------------------------------------------


def test_histogram_ops_match_reference():
    rng = np.random.default_rng(41)
    n, m, bins = 150, 40, 32
    birth = rng.integers(0, 20, m).astype(np.int32)
    first = np.where(rng.random((n, m)) < 0.6,
                     birth[None, :] + rng.integers(0, 45, (n, m)), -1
                     ).astype(np.int32)
    msg_mask = rng.random(m) < 0.8
    peer_mask = rng.random(n) < 0.9
    args = (first, birth, msg_mask, peer_mask)
    _eq(thist.latency_histogram(*map(_t, args), bins),
        jhist.latency_histogram(*map(jnp.asarray, args), bins))
    seed_fn = jax.jit(jhist.latency_histogram_seed, static_argnums=4)
    _eq(thist.latency_histogram_seed(*map(_t, args), bins),
        seed_fn(*map(jnp.asarray, args), bins), "seed, full branch")
    # The fresh-publish state: every counted receipt at latency zero.
    fresh = np.where(first >= 0, birth[None, :], -1).astype(np.int32)
    args0 = (fresh, birth, msg_mask, peer_mask)
    _eq(thist.latency_histogram_seed(*map(_t, args0), bins),
        seed_fn(*map(jnp.asarray, args0), bins), "seed, cheap branch")
    per_msg = rng.integers(0, 50, m).astype(np.int32)
    _eq(thist.latency_histogram_increment(_t(per_msg), _t(birth),
                                          _t(msg_mask), 23, bins),
        jhist.latency_histogram_increment(jnp.asarray(per_msg),
                                          jnp.asarray(birth),
                                          jnp.asarray(msg_mask), 23, bins))
    for counts in (rng.integers(0, 9, bins), np.zeros(bins, int),
                   np.eye(1, bins, 5)[0] * 3):
        counts = counts.astype(np.int32)
        for q in (0.5, 0.9, 0.99):
            _eq(thist.hist_quantile(_t(counts), q),
                jhist.hist_quantile(jnp.asarray(counts), q), f"q={q}")
    vals = rng.normal(0, 1, n).astype(np.float32)
    with_inf = vals.copy()
    with_inf[::17] = -np.inf  # a PX slot not scored yet averages to -inf
    for vals, mask in ((vals, peer_mask), (vals, np.zeros(n, bool)),
                       (with_inf, peer_mask)):
        _eq(thist.binned_quantiles(_t(vals), _t(mask), (0.1, 0.5, 0.9)),
            jax.jit(jhist.binned_quantiles, static_argnums=2)(
                jnp.asarray(vals), jnp.asarray(mask), (0.1, 0.5, 0.9)))


# -- the kernels' plain versions vs jnp and Pallas ------------------------------

GEOMETRIES = [(0, 512, 32), (1, 200, 8), (2, 589, 16)]


def _propagate_inputs(seed, n, k, m=128):
    rng, g = _graph(seed, n, k)
    have = rng.random((n, m)) < 0.2
    fresh = have & (rng.random((n, m)) < 0.5)
    valid = rng.random(m) < 0.8
    words = lambda x: np.asarray(jbp.pack(jnp.asarray(x)))  # noqa: E731
    args = (g["mesh"], g["nbrs"], g["edge_live"], g["alive"], words(have),
            words(fresh), words(valid))
    return rng, args


@pytest.mark.parametrize("arm", ["plain", "idontwant", "fresh_src"])
@pytest.mark.parametrize("seed,n,k", GEOMETRIES)
def test_propagate_matches_jnp_and_pallas(arm, seed, n, k):
    rng, args = _propagate_inputs(seed, n, k)
    w = args[4].shape[1]
    kw_j, kw_t = {}, {}
    if arm == "idontwant":
        idw = args[4] & rng.integers(0, 2**32, (n, w), dtype=np.uint32)
        kw_j = dict(idontwant=True, idw_have_w=jnp.asarray(idw))
        kw_t = dict(idontwant=True, idw_have_w=_t(idw))
    elif arm == "fresh_src":
        src = rng.integers(0, 2**32, (n, k, w), dtype=np.uint32)
        kw_j, kw_t = dict(fresh_src=jnp.asarray(src)), dict(fresh_src=_t(src))
    jargs = tuple(jnp.asarray(a) for a in args)
    targs = tuple(_t(a) for a in args)
    ref = jax.jit(lambda *a: jgp.propagate_packed(*a, **kw_j))(*jargs)
    pal = propagate_packed_pallas(*jargs, interpret=True, **kw_j)
    out = tgp.propagate_packed(*targs, **kw_t)
    wrapped = cuda_gossip.propagate(*targs, **kw_t)   # CPU: the plain version
    for name, a, b, c, d in zip(jgp.PropagatePackedOut._fields, out, ref, pal,
                                wrapped):
        _eq(a, b, f"{name} vs jnp")
        _eq(a, c, f"{name} vs pallas")
        _eq(d, b, f"{name} wrapper")
    assert int(np.asarray(ref.fmd_inc).sum()) > 0


def _exchange_inputs(seed, n, k, m=128):
    rng, g = _graph(seed, n, k)
    have = rng.random((n, m)) < 0.3
    dedup = have & (rng.random((n, m)) < 0.9)
    scores = rng.normal(0, 1, (n, k)).astype(np.float32)
    serve_ok = rng.random((n, k)) < 0.66
    gw = rng.random(m) < 0.8
    words = lambda x: np.asarray(jbp.pack(jnp.asarray(x)))  # noqa: E731
    return (words(have), words(dedup), g["mesh"], g["nbrs"], g["rev"],
            g["edge_live"], g["alive"], scores, words(gw), serve_ok)


# Small caps so the word-granular cap logic binds (the defaults never bind
# at M=128); the second row keeps the caps off.
CAPS = [(70, 40), (5000, 5000)]


@pytest.mark.parametrize("caps", CAPS)
@pytest.mark.parametrize("seed,n,k", GEOMETRIES)
def test_gossip_exchange_matches_jnp_and_pallas(caps, seed, n, k):
    have, dedup, mesh, nbrs, rev, el, alive, scores, gw, serve = (
        _exchange_inputs(seed, n, k))
    p = JP(d_lazy=6, max_ihave_length=caps[0])
    tp = bridge.params_from(p)
    jka, tka = _keys(seed)
    jki, tki = _keys(seed + 50)

    def jargs():
        return (jka, jki, jnp.asarray(have), jnp.asarray(dedup),
                jnp.asarray(mesh), jnp.asarray(nbrs), jnp.asarray(rev),
                jnp.asarray(el), jnp.asarray(alive), jnp.asarray(scores),
                jnp.asarray(gw), p, -0.5, jnp.asarray(serve), caps[1])

    targs = (tka, tki, _t(have), _t(dedup), _t(mesh), _t(nbrs), _t(rev),
             _t(el), _t(alive), _t(scores), _t(gw), tp, -0.5, _t(serve),
             caps[1])
    ref = jgp.gossip_exchange_packed(*jargs())
    pal = gossip_exchange_packed_pallas(*jargs(), interpret=True)
    out = tgp.gossip_exchange_packed(*targs)
    for i in range(2):
        _eq(out[i], ref[i], f"output {i} vs jnp")
        _eq(out[i], pal[i], f"output {i} vs pallas")
    assert int(np.asarray(ref[0]).astype(bool).sum()) > 0


@pytest.mark.parametrize("seed,n,k", GEOMETRIES[:2])
def test_unfused_advertise_select_pair_matches_reference(seed, n, k):
    have, dedup, mesh, nbrs, rev, el, alive, scores, gw, serve = (
        _exchange_inputs(seed, n, k))
    p = JP(d_lazy=6, max_ihave_length=70)
    jka, tka = _keys(seed)
    jki, tki = _keys(seed + 50)
    adv_j = jgp.ihave_advertise_packed(
        jka, jnp.asarray(have), jnp.asarray(mesh), jnp.asarray(nbrs),
        jnp.asarray(rev), jnp.asarray(el), jnp.asarray(alive),
        jnp.asarray(scores), jnp.asarray(gw), p, -0.5)
    adv_t = tgp.ihave_advertise_packed(
        tka, _t(have), _t(mesh), _t(nbrs), _t(rev), _t(el), _t(alive),
        _t(scores), _t(gw), bridge.params_from(p), -0.5)
    _eq(adv_t, adv_j, "adv")
    ref = jgp.iwant_select_packed(
        jki, adv_j, jnp.asarray(dedup), jnp.asarray(el), jnp.asarray(scores),
        jnp.asarray(serve), jnp.asarray(alive), 40, -0.5)
    out = tgp.iwant_select_packed(
        tki, adv_t, _t(dedup), _t(el), _t(scores), _t(serve), _t(alive), 40,
        -0.5)
    _eq(out[0], ref[0], "pend")
    _eq(out[1], ref[1], "broken")
    fused = tgp.gossip_exchange_packed(
        tka, tki, _t(have), _t(dedup), _t(mesh), _t(nbrs), _t(rev), _t(el),
        _t(alive), _t(scores), _t(gw), bridge.params_from(p), -0.5,
        _t(serve), 40)
    _eq(fused[0], out[0].numpy(), "fused pend")
    _eq(fused[1], out[1].numpy(), "fused broken")


def test_wrappers_run_the_plain_version_on_cpu_tensors_only():
    """On CPU tensors the wrappers are the plain versions (which take any
    K) and launch nothing; other devices are refused."""
    n, k = 4, 33
    z = lambda *s, dt=torch.bool: torch.zeros(s, dtype=dt)  # noqa: E731
    before = (cuda_gossip.propagate.launches,
              cuda_gossip.exchange_select.launches)
    out = cuda_gossip.propagate(
        z(n, k), z(n, k, dt=torch.int32), z(n, k), z(n),
        z(n, 1, dt=torch.int32), z(n, 1, dt=torch.int32), z(1, dt=torch.int32))
    assert tuple(out.fmd_inc.shape) == (n, k)
    pend, broken = cuda_gossip.exchange_select(
        z(n, k, dt=torch.int32), z(n, k), z(n, k), z(n, k),
        z(n, 1, dt=torch.int32), z(n, 1, dt=torch.int32), z(n), 5, 5)
    assert tuple(broken.shape) == (n, k) and not pend.any()
    assert (cuda_gossip.propagate.launches,
            cuda_gossip.exchange_select.launches) == before
    meta = torch.zeros((n, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gossip.propagate(
            z(n, k), z(n, k, dt=torch.int32), z(n, k), z(n), meta, meta,
            z(1, dt=torch.int32))
