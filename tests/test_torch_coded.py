"""The port's coded plane held against the JAX package's: ``rng.randint``,
GF(256) arithmetic, the loss estimator, ``GossipSub._propagate``'s hybrid
hooks, ``RLNC`` (rollouts, the scenario event path, the blocked draw) and
``HybridGossipSub`` (decimation and Bernoulli loss, the eager twin, the
always-computed coded branch), the bridge, and the coded trace module.

Both sides start from the same inputs (numpy, from a seed) or from one
bridged state; every comparison is exact (float32 compared by its bits).

The committed coded trace (``go_libp2p_pubsub_torch/models/traces/
coded.trace.json``) is the JAX package's models run through
``models/coded_trace.py``; the card replays it.  To rewrite it after a
deliberate change of the reference:

    JAX_PLATFORMS=cpu python tests/test_torch_coded.py --write
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from go_libp2p_pubsub_torch.models import coded_trace as CT  # noqa: E402

# The committed trace's peer counts (see CHANGES.md for why this size).
TRACE_PEERS = (16384, 65536)


class JaxEngine:
    """The JAX package's RLNC/HybridGossipSub behind the coded trace's
    engine interface."""

    def rlnc(self, cfg):
        from go_libp2p_pubsub_tpu.models.rlnc import RLNC

        return RLNC(**cfg)

    def hybrid(self, cfg):
        from go_libp2p_pubsub_tpu.models.hybrid import HybridGossipSub

        return HybridGossipSub(**cfg)

    def init(self, model, seed):
        return model.init(seed)

    def set_delay(self, model, st, delay):
        import jax.numpy as jnp

        return model.set_gossip_delay(st, jnp.asarray(delay))

    def set_loss(self, model, st, d):
        return model.set_ingress_loss(st, d)

    def set_loss_p(self, model, st, p):
        return model.set_ingress_loss_p(st, p)

    def publish(self, model, st, src, slot, valid):
        import jax.numpy as jnp

        return model.publish(st, jnp.int32(src), jnp.int32(slot),
                             jnp.asarray(valid))

    def step_recorded(self, model, st):
        st, per_msg = model.step_recorded(st)
        return st, np.asarray(per_msg)

    def views(self, model, st):
        from go_libp2p_pubsub_tpu.ops import gf256 as jgf

        out = {"rank": np.asarray(jgf.gf_rank(st.basis))}
        if hasattr(st, "gossip"):
            out["first_step"] = np.asarray(st.gossip.first_step)
            out["coded"] = np.asarray(st.coded & st.gossip.nbr_valid)
            out["loss_ewma"] = np.asarray(st.loss_ewma)
        else:
            out["first_step"] = np.asarray(st.first_step)
        return out

    def delivery_stats(self, model, st):
        return tuple(np.asarray(x) for x in model.delivery_stats(st))

    def leaves(self, model, st):
        return CT.flatten(st)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_coded.py --write")
    import jax

    jax.config.update("jax_platforms", "cpu")
    CT.write_trace(JaxEngine(), CT.header(*TRACE_PEERS))
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from go_libp2p_pubsub_tpu.models.gossipsub import GossipSub as JG  # noqa: E402
from go_libp2p_pubsub_tpu.models.hybrid import HybridGossipSub as JH  # noqa: E402
from go_libp2p_pubsub_tpu.models.rlnc import RLNC as JR  # noqa: E402
from go_libp2p_pubsub_tpu.ops import gf256 as jgf  # noqa: E402
from go_libp2p_pubsub_tpu.ops import loss_estimator as jloss  # noqa: E402
from go_libp2p_pubsub_torch import bridge  # noqa: E402
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub as TG  # noqa: E402
from go_libp2p_pubsub_torch.models.hybrid import HybridGossipSub as TH  # noqa: E402
from go_libp2p_pubsub_torch.models.rlnc import RLNC as TR  # noqa: E402
from go_libp2p_pubsub_torch.ops import gf256 as tgf  # noqa: E402
from go_libp2p_pubsub_torch.ops import loss_estimator as tloss  # noqa: E402
from go_libp2p_pubsub_torch.ops import reduce_order, rng  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_leaves(ref, port, what):
    """Every leaf of two numpy-form NamedTuple states, dtype, shape and
    bits."""
    la, lb = CT.flatten(ref), CT.flatten(port)
    assert la.keys() == lb.keys(), what
    for name in la:
        a, b = la[name], lb[name]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(_bits(b), _bits(a),
                                      err_msg=f"{what}: {name}")


def assert_same_record(ref, port, what):
    assert set(ref) == set(port), what
    for name in ref:
        a = np.asarray(ref[name])
        b = port[name].cpu().numpy() if isinstance(
            port[name], torch.Tensor) else np.asarray(port[name])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(_bits(b), _bits(a),
                                      err_msg=f"{what}: {name}")


def u8(rs, shape):
    return rs.integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# randint, GF(256), the loss estimator
# ---------------------------------------------------------------------------

_SPANS = [(0, 256), (0, 255), (3, 1000), (5, 5), (7, 2), (-7, 60001),
          (0, 65536), (0, 65537), (-100, 2**31 - 1), (-2**31, 2**31 - 1)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_randint_matches_jax(seed):
    for shape in ((5,), (3, 4, 5), (7, 2, 3)):
        for lo, hi in _SPANS:
            ref = np.asarray(jax.random.randint(
                jax.random.PRNGKey(seed), shape, lo, hi, dtype=jnp.int32))
            out = rng.randint(rng.PRNGKey(seed), shape, lo, hi).numpy()
            assert out.dtype == np.int32
            np.testing.assert_array_equal(out, ref, err_msg=f"{lo},{hi}")
            # A block of rows draws the whole draw's rows.
            blk = rng.randint(rng.PRNGKey(seed), (2,) + shape[1:], lo, hi,
                              row_offset=shape[0] - 2).numpy()
            np.testing.assert_array_equal(blk, ref[-2:])
    with pytest.raises(OverflowError):
        rng.randint(rng.PRNGKey(0), (3,), 0, 2**31)


def test_gf_product_over_all_pairs_in_both_forms():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    b = a.T.copy()
    ref = np.asarray(jgf.gf_mul(jnp.asarray(a), jnp.asarray(b)))
    out = tgf.gf_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    # The plane-matmul form: a [256, 1] x [1, 256] outer product per pair.
    col = np.arange(256, dtype=np.uint8)
    mxu = tgf.gf_matmul_mxu(torch.from_numpy(col[:, None]),
                            torch.from_numpy(col[None, :])).numpy()
    np.testing.assert_array_equal(mxu, ref.T)
    np.testing.assert_array_equal(tgf.GF_EXP, jgf.GF_EXP)
    np.testing.assert_array_equal(tgf.GF_LOG, jgf.GF_LOG)


def test_gf_inv_combine_matmul_match_reference():
    rs = np.random.default_rng(3)
    x = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tgf.gf_inv(torch.from_numpy(x)).numpy(),
        np.asarray(jgf.gf_inv(jnp.asarray(x))))
    c, rows = u8(rs, (5, 7, 6)), u8(rs, (5, 7, 6, 11))
    ref = np.asarray(jgf.gf_combine(jnp.asarray(c), jnp.asarray(rows)))
    tc, tr_ = torch.from_numpy(c), torch.from_numpy(rows)
    np.testing.assert_array_equal(tgf.gf_combine(tc, tr_).numpy(), ref)
    np.testing.assert_array_equal(tgf.gf_combine_mxu(tc, tr_).numpy(), ref)
    a, b = u8(rs, (4, 9, 13)), u8(rs, (4, 13, 6))
    ref = np.asarray(jgf.gf_matmul(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(tgf.gf_matmul(ta, tb).numpy(), ref)
    np.testing.assert_array_equal(tgf.gf_matmul_mxu(ta, tb).numpy(), ref)
    np.testing.assert_array_equal(
        np.asarray(jgf.gf_matmul_mxu(jnp.asarray(a), jnp.asarray(b))), ref)


def _rref_cases(rs, kk=6, batch=40):
    """Bases built by the reference's inserts, and the vectors to fold:
    independent, dependent (a combination of present rows), zero, and
    inserts into full-rank bases."""
    ins = jax.jit(jax.vmap(jgf.rref_insert))
    basis = jnp.zeros((batch, kk, kk), jnp.uint8)
    for _ in range(rs.integers(0, kk + 1)):
        basis = ins(basis, jnp.asarray(u8(rs, (batch, kk))))[0]
    full = jnp.zeros((batch, kk, kk), jnp.uint8)
    for _ in range(3 * kk):
        full = ins(full, jnp.asarray(u8(rs, (batch, kk))))[0]
    b = np.asarray(basis)
    dep = np.asarray(jgf.gf_combine(jnp.asarray(u8(rs, (batch, kk))),
                                    jnp.asarray(b)))
    vecs = {"random": u8(rs, (batch, kk)), "dependent": dep,
            "zero": np.zeros((batch, kk), np.uint8)}
    return ins, b, np.asarray(full), vecs


def test_rref_insert_and_rank_match_reference():
    rs = np.random.default_rng(5)
    ins, b, full, vecs = _rref_cases(rs)
    for name, v in list(vecs.items()) + [("full", u8(rs, b.shape[:2]))]:
        base = full if name == "full" else b
        rb, ri = ins(jnp.asarray(base), jnp.asarray(v))
        tb, ti = tgf.rref_insert(torch.from_numpy(base), torch.from_numpy(v))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(rb), name)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri), name)
        np.testing.assert_array_equal(
            tgf.gf_rank(tb).numpy(), np.asarray(jgf.gf_rank(rb)))
        if name in ("dependent", "zero", "full"):
            assert not ti.any(), name
    assert (tgf.gf_rank(torch.from_numpy(full)).numpy() == 6).all()


@pytest.mark.parametrize("case", ["invertible", "singular", "permuted"])
def test_gf_solve_matches_reference(case):
    rs = np.random.default_rng({"invertible": 1, "singular": 2,
                                "permuted": 3}[case])
    a, b = u8(rs, (5, 5)), u8(rs, (5, 7))
    if case == "singular":
        a[3] = np.asarray(jgf.gf_combine(jnp.asarray(u8(rs, (3,))),
                                         jnp.asarray(a[:3])))
    if case == "permuted":
        a = np.eye(5, dtype=np.uint8)[[2, 0, 4, 1, 3]] * u8(rs, (5, 1))
        a[a == 0] = 0
        a[np.arange(5), [2, 0, 4, 1, 3]] |= 1
    rx, rok = jgf.gf_solve(jnp.asarray(a), jnp.asarray(b))
    tx, tok = tgf.gf_solve(torch.from_numpy(a), torch.from_numpy(b))
    assert bool(tok) == bool(rok) == (case != "singular")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(rx))


def test_loss_ewma_bits_and_hysteresis_match_reference():
    rs = np.random.default_rng(9)
    ew = rs.random((300, 16)).astype(np.float32)
    exp_, obs = rs.random((300, 16)) < 0.7, rs.random((300, 16)) < 0.5
    coded = rs.random((300, 16)) < 0.5
    te = (torch.from_numpy(ew), torch.from_numpy(exp_), torch.from_numpy(obs))
    for alpha in (0.25, 0.1, 0.3):
        # The hybrid folds inside its jitted round.
        ref = np.asarray(jax.jit(jloss.ewma_update, static_argnums=3)(
            ew, exp_, obs, alpha))
        out = tloss.ewma_update(*te, alpha).numpy()
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    for hi, lo in ((0.35, 0.15), (0.5, 0.49)):
        ref = np.asarray(jloss.hysteresis_switch(ew, coded, hi, lo))
        out = tloss.hysteresis_switch(te[0], torch.from_numpy(coded), hi, lo)
        np.testing.assert_array_equal(out.numpy(), ref)
    # A clean fabric is a fixed point at 0.0 with nothing coded.
    z = torch.zeros((4, 16))
    est = tloss.update(tloss.LossEstimate(z, z.bool()),
                       torch.ones((4, 16), dtype=torch.bool),
                       torch.ones((4, 1), dtype=torch.bool), 0.25, 0.35, 0.15)
    assert not est.coded.any() and (est.loss_ewma == 0).all()


@pytest.mark.parametrize("shape", [(64, 16), (100, 16), (1000, 16),
                                   (31, 16), (2000, 32), (100,)])
def test_xla_sum_matches_jitted_sum(shape):
    rs = np.random.default_rng(sum(shape))
    x = (rs.random(shape) * (rs.random(shape) < 0.6)).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.sum)(x))
    out = reduce_order.xla_sum(torch.from_numpy(x)).numpy()
    assert out.view(np.int32) == ref.view(np.int32)


# ---------------------------------------------------------------------------
# _propagate's hybrid hooks
# ---------------------------------------------------------------------------


def test_propagate_hooks_match_reference():
    kw = dict(n_peers=64, n_slots=16, conn_degree=8, msg_window=16,
              heartbeat_steps=4)
    jm, tm = JG(use_pallas=False, **kw), TG(device="cpu", **kw)
    js = jm.init(2)
    for src, slot in ((0, 0), (7, 1), (9, 2)):
        js = jm.publish(js, src, slot, True)
    js = jm.step(jm.step(js))
    rs = np.random.default_rng(4)
    eok = rs.random((64, 16)) < 0.6
    iok = rs.random(64) < 0.5
    jw = jm._widen_indices(js)
    ts = tm._widen_indices(bridge.state_from_jax(js, "cpu"))
    for e, i in ((eok, iok), (None, iok), (eok, None), (None, None)):
        ref, rpm = jm._propagate(
            jw, with_receipts=True,
            eager_edge_ok=None if e is None else jnp.asarray(e),
            ingress_ok=None if i is None else jnp.asarray(i))
        out, tpm = tm._propagate(
            ts, with_receipts=True,
            eager_edge_ok=None if e is None else torch.from_numpy(e),
            ingress_ok=None if i is None else torch.from_numpy(i))
        assert_same_leaves(jm._narrow_indices(ref),
                           bridge.state_to_numpy(tm._narrow_indices(out)),
                           f"hooks {e is None} {i is None}")
        np.testing.assert_array_equal(tpm.numpy(), np.asarray(rpm))


# ---------------------------------------------------------------------------
# RLNC
# ---------------------------------------------------------------------------

_RLNC = dict(n_peers=64, n_slots=8, conn_degree=4, msg_window=8, gen_size=4)


@pytest.fixture(scope="module")
def rlnc_ref():
    """The reference's recorded rollouts, clean and with a quarter of the
    peers decimated, from one published state."""
    jm = JR(**_RLNC)
    js = jm.init(3)
    for src, slot, ok in ((0, 0, True), (5, 1, True), (9, 2, False),
                          (11, 3, True)):
        js = jm.publish(js, src, slot, ok)
    delay = np.zeros(64, np.int32)
    delay[np.random.default_rng(0).choice(64, 16, replace=False)] = 2
    out = {"init": js, "delay": delay}
    out["clean"] = jm.rollout(js, 10, record=True)
    out["decimated"] = jm.rollout(
        jm.set_gossip_delay(js, jnp.asarray(delay)), 10, record=True)
    return out


@pytest.mark.parametrize("mode", ["clean", "decimated"])
def test_rlnc_rollout_matches_reference(rlnc_ref, mode):
    tm = TR(device="cpu", **_RLNC)
    ts = bridge.rlnc_state_from_numpy(rlnc_ref["init"], "cpu")
    if mode == "decimated":
        ts = tm.set_gossip_delay(ts, rlnc_ref["delay"])
    tf, trec = tm.rollout(ts, 10, record=True)
    jf, jrec = rlnc_ref[mode]
    assert_same_leaves(jf, bridge.rlnc_state_to_numpy(tf), mode)
    assert_same_record(jrec, trec, mode)
    for a, b in zip(JR(**_RLNC).delivery_stats(jf), tm.delivery_stats(tf)):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(np.asarray(a)))
    # A fresh port state from init() equals the reference's init.
    fresh = TR(device="cpu", **_RLNC).init(3)
    assert_same_leaves(JR(**_RLNC).init(3),
                       bridge.rlnc_state_to_numpy(fresh), "init")


def test_blocked_rlnc_step_equals_whole_step(rlnc_ref, monkeypatch):
    from go_libp2p_pubsub_torch.models import rlnc as trlnc

    whole = TR(device="cpu", **_RLNC)
    st = whole.set_gossip_delay(
        bridge.rlnc_state_from_numpy(rlnc_ref["init"], "cpu"),
        rlnc_ref["delay"])
    assert trlnc.draw_block(8, 8, 4) >= 64                 # one block
    a = st
    for _ in range(4):
        a = whole.step(a)
    # Blocks of 7 senders (the last one ragged) draw the same bits.
    monkeypatch.setattr(trlnc, "DRAW_BLOCK_ELEMS", 7 * 8 * 8 * 4)
    assert trlnc.draw_block(8, 8, 4) == 7
    b = st
    for _ in range(4):
        b = whole.step(b)
    assert_same_leaves(bridge.rlnc_state_to_numpy(a),
                       bridge.rlnc_state_to_numpy(b), "blocked")
    # The mxu arm encodes the same fragments.
    mxu = TR(device="cpu", use_mxu=True, **_RLNC)
    assert_same_leaves(bridge.rlnc_state_to_numpy(whole.step(st)),
                       bridge.rlnc_state_to_numpy(mxu.step(st)), "mxu")


def test_degraded_links_rlnc_campaign_matches_reference():
    from go_libp2p_pubsub_tpu import scenario as jscn
    from go_libp2p_pubsub_torch import scenario as tscn
    from go_libp2p_pubsub_torch.scenario.runner import flight_to_jsonable

    name = "degraded_links_rlnc"
    ref = jscn.run_scenario(jscn.build(name))
    out = tscn.run_scenario(tscn.build(name), device="cpu")
    for a, b in zip(ref.compiled.events, out.compiled.events):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert out.compiled.n_publishes == ref.compiled.n_publishes
    assert flight_to_jsonable(out.record) == flight_to_jsonable(
        {k: np.asarray(v) for k, v in ref.record.items()})
    assert out.verdict.to_dict() == ref.verdict.to_dict()
    assert out.verdict.passed
    assert_same_leaves(ref.final_state,
                       bridge.rlnc_state_to_numpy(out.final_state), name)


# ---------------------------------------------------------------------------
# HybridGossipSub
# ---------------------------------------------------------------------------

_HYB = dict(n_peers=64, n_slots=16, conn_degree=6, msg_window=16,
            heartbeat_steps=4, gen_size=4)


def _hybrid_start(jm):
    js = jm.init(3)
    for src, slot in ((0, 0), (5, 1), (9, 2), (11, 3), (20, 4)):
        js = jm.publish(js, jnp.int32(src), jnp.int32(slot),
                        jnp.asarray(True))
    return js


@pytest.fixture(scope="module")
def hybrid_ref():
    jm = JH(**_HYB)
    js = _hybrid_start(jm)
    return {
        "init": js,
        "decimation": jm.rollout(jm.set_ingress_loss(js, 2), 12, record=True),
        "bernoulli": jm.rollout(jm.set_ingress_loss_p(js, 0.4), 12,
                                record=True),
    }


@pytest.mark.parametrize("mode", ["decimation", "bernoulli"])
def test_hybrid_rollout_matches_reference(hybrid_ref, mode):
    tm = TH(device="cpu", **_HYB)
    ts = bridge.hybrid_state_from_numpy(hybrid_ref["init"], "cpu")
    ts = (tm.set_ingress_loss(ts, 2) if mode == "decimation"
          else tm.set_ingress_loss_p(ts, 0.4))
    tf, trec = tm.rollout(ts, 12, record=True)
    jf, jrec = hybrid_ref[mode]
    assert int(np.asarray(jrec["coded_edges"])[-1]) > 0
    assert_same_leaves(jf, bridge.hybrid_state_to_numpy(tf), mode)
    assert_same_record(jrec, trec, mode)
    # Published and stepped by the port from its own init.
    own = tm.init(3)
    for src, slot in ((0, 0), (5, 1), (9, 2), (11, 3), (20, 4)):
        own = tm.publish(own, src, slot, True)
    assert_same_leaves(hybrid_ref["init"],
                       bridge.hybrid_state_to_numpy(own), "publish")


def test_hybrid_clean_fabric_equals_the_eager_twin():
    """At d = 0 the adaptive model and its eager-forced twin (switch
    thresholds above 1) run leaf for leaf alike, as the reference's do."""
    ada, twin = TH(device="cpu", **_HYB), TH(
        device="cpu", switch_hi=2.0, switch_lo=1.5, **_HYB)
    jm = JH(**_HYB)
    js = _hybrid_start(jm)
    jf, jrec = jm.rollout(js, 10, record=True)
    start = bridge.hybrid_state_from_numpy(js, "cpu")
    af, arec = ada.rollout(start, 10, record=True)
    tf, trec = twin.rollout(start, 10, record=True)
    an, tn = bridge.hybrid_state_to_numpy(af), bridge.hybrid_state_to_numpy(tf)
    assert_same_leaves(an, tn, "twin")
    assert_same_leaves(jf, an, "reference")
    assert_same_record(jrec, arec, "reference")
    assert not an.coded.any() and (an.loss_ewma == 0).all()


def test_round_without_coded_edges_equals_the_skipped_cond():
    """A round where no edge is coded: the port's always-computed branch,
    selected away, equals the reference's skipped ``lax.cond``; the next
    rounds (edges switching under loss) take it."""
    jm, tm = JH(**_HYB), TH(device="cpu", **_HYB)
    js = jm.set_ingress_loss(_hybrid_start(jm), 1)
    ts = bridge.hybrid_state_from_numpy(js, "cpu")
    took = []
    for r in range(6):
        took.append(bool(np.asarray(js.coded).any()))
        js, jpm = jm.step_recorded(js)
        ts, tpm = tm.step_recorded(ts)
        assert_same_leaves(js, bridge.hybrid_state_to_numpy(ts), f"round {r}")
        np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm))
    assert not took[0] and any(took)


def test_hybrid_views_match_reference(hybrid_ref):
    jm, tm = JH(**_HYB), TH(device="cpu", **_HYB)
    jf = hybrid_ref["decimation"][0]
    tf = bridge.hybrid_state_from_numpy(jf, "cpu")
    ref = jm.stream_digest(jf)
    out = tm.stream_digest(tf)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    for frac in (0.5, 0.99):
        np.testing.assert_array_equal(
            tm.stream_deliver_steps(tf, 4, frac).numpy(),
            np.asarray(jm.stream_deliver_steps(jf, 4, frac)))
    assert tm.decode_rank_summary(tf) == jm.decode_rank_summary(jf)
    for a, b in zip(jm.delivery_stats(jf), tm.delivery_stats(tf)):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(np.asarray(a)))
    assert tm.stream_model_key() == jm.stream_model_key()
    assert tm == TH(device="cpu", **_HYB) and hash(tm) == hash(
        TH(device="cpu", **_HYB))
    assert tm != TH(device="cpu", switch_hi=2.0, switch_lo=1.5, **_HYB)


# ---------------------------------------------------------------------------
# entry points, bridge, the trace module
# ---------------------------------------------------------------------------


def test_entry_points_refuse_peer_uid_and_a_missing_card(monkeypatch):
    """Placement relabeling (``peer_uid``) is ported: under a permutation
    RLNC and the hybrid run leaf for leaf as the reference's (coefficients
    and the eager plane's draws keyed on canonical identity, the blocked
    coefficient draw included); a malformed ``peer_uid`` is refused with
    the reference's message; a missing card still refuses."""
    from go_libp2p_pubsub_torch.models import rlnc as trlnc

    perm = np.random.default_rng(11).permutation(64)
    jm = JR(peer_uid=perm, **_RLNC)
    js = jm.init(3)
    for src, slot, ok in ((0, 0, True), (5, 1, True), (9, 2, False)):
        js = jm.publish(js, src, slot, ok)
    jf, jrec = jm.rollout(js, 4, record=True)
    tm = TR(device="cpu", peer_uid=perm, **_RLNC)
    ts = bridge.rlnc_state_from_numpy(js, "cpu")
    tf, trec = tm.rollout(ts, 4, record=True)
    assert_same_leaves(jf, bridge.rlnc_state_to_numpy(tf), "rlnc uid")
    assert_same_record(jrec, trec, "rlnc uid")
    assert tm != TR(device="cpu", **_RLNC)
    # Blocks of 5 senders (the last one ragged) draw the uid rows alone.
    monkeypatch.setattr(trlnc, "DRAW_BLOCK_ELEMS", 5 * 8 * 8 * 4)
    tb, _ = tm.rollout(ts, 4, record=True)
    assert_same_leaves(jf, bridge.rlnc_state_to_numpy(tb), "rlnc blocked")
    monkeypatch.undo()

    jh = JH(peer_uid=perm, **_HYB)
    jhs = jh.set_ingress_loss_p(_hybrid_start(jh), 0.4)
    jhf, jhrec = jh.rollout(jhs, 9, record=True)
    th = TH(device="cpu", peer_uid=perm, **_HYB)
    ths = bridge.hybrid_state_from_numpy(jhs, "cpu")
    thf, threc = th.rollout(ths, 9, record=True)
    assert int(np.asarray(jhrec["coded_edges"])[-1]) > 0
    assert_same_leaves(jhf, bridge.hybrid_state_to_numpy(thf), "hybrid uid")
    assert_same_record(jhrec, threc, "hybrid uid")
    # The port's own init: colocation labels are the canonical ids.
    assert_same_leaves(jh.init(3), bridge.hybrid_state_to_numpy(th.init(3)),
                       "hybrid uid init")

    for cls, jcls, kw in ((TR, JR, _RLNC), (TH, JH, _HYB)):
        for bad in (np.arange(63), np.zeros(64, np.int64)):
            with pytest.raises(ValueError) as te:
                cls(device="cpu", peer_uid=bad, **kw)
            with pytest.raises(ValueError) as je:
                jcls(peer_uid=bad, **kw)
            assert str(te.value) == str(je.value)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls(**kw)
    for bad in (dict(gen_size=0), dict(switch_hi=0.1, switch_lo=0.2),
                dict(ewma_alpha=0.0)):
        with pytest.raises(ValueError) as te:
            TH(device="cpu", **dict(_HYB, **bad))
        with pytest.raises(ValueError) as je:
            JH(**dict(_HYB, **bad))
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="ingress_loss_p"):
        TH(device="cpu", **_HYB).set_ingress_loss_p(None, 1.0)


def test_bridge_round_trips_coded_states(hybrid_ref, rlnc_ref):
    js = hybrid_ref["decimation"][0]
    back = bridge.hybrid_state_to_numpy(bridge.hybrid_state_from_numpy(
        js, "cpu"))
    assert_same_leaves(js, back, "hybrid")
    assert back.key_coded.dtype == np.uint32
    spec = bridge.hybrid_state_spec(bridge.hybrid_state_from_numpy(js, "cpu"))
    for a, b in zip(CT.flatten(back).values(), CT.flatten(spec).values()):
        assert a.dtype == b.dtype and a.shape == b.shape
    jr = rlnc_ref["decimated"][0]
    assert_same_leaves(jr, bridge.rlnc_state_to_numpy(
        bridge.rlnc_state_from_numpy(jr, "cpu")), "rlnc")


def test_coded_trace_hybrid_runs_match_reference():
    """The trace module's hybrid half at 64 peers, both engines (the RLNC
    half at the trace's widths is the card's; the rollouts above hold the
    RLNC model)."""
    hdr = CT.header(64, 64)
    ref = CT.run(JaxEngine(), hdr, runs=CT.HYBRID_RUNS)
    out = CT.run(CT.PortEngine("cpu"), hdr, runs=CT.HYBRID_RUNS)
    assert CT.mismatches(out, ref) == []
    assert set(ref["runs"]) == set(CT.HYBRID_RUNS)
    assert all(r["steps"][-1]["coded_edges"] > 0
               for r in ref["runs"].values())


def test_committed_coded_trace_is_whole():
    doc = CT.load_trace()
    assert doc["header"] == CT.header(*TRACE_PEERS)
    assert set(doc["runs"]) == set(CT.RLNC_RUNS + CT.HYBRID_RUNS)
    bad = dict(doc, runs=dict(doc["runs"]))
    run = dict(bad["runs"]["hybrid_bernoulli"])
    run["steps"] = [dict(s) for s in run["steps"]]
    run["steps"][3]["coded_edges"] += 1
    run["p99"] = "0x0p+0"
    bad["runs"]["hybrid_bernoulli"] = run
    assert CT.mismatches(bad, doc) == [
        "hybrid_bernoulli/step 3/coded_edges", "hybrid_bernoulli/p99"]
    final = doc["runs"]["rlnc_degraded"]["steps"][-1]["rank_hist"]
    assert final[-1] > 0
