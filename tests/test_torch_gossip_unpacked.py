"""The port's unpacked gossip plane and its last missing names, held
against the JAX package on the CPU.

The unpacked boolean [N, K, M] forms of the eager push and the IHAVE/IWANT
exchange (``ops/gossip.py``) are the reference semantics the packed ops
and kernels K1/K2 are held to.  Each is compared with the JAX function bit
for bit on inputs made with numpy from a seed, and the port's plain packed
ops are held to them (the three identities of the reference's
``tests/test_gossip_packed.py``).  The rest are the names the port lacked:
``GossipSub.run`` and ``masked_mean``, ``histogram.masked_quantiles``,
``config.to_json``/``tree_opts_from_dict``, ``native.sha512``/``verify``
and ``gossip_packed.FULL``.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import config as jcfg
from go_libp2p_pubsub_tpu.crypto import native as jnative
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSub as JG
from go_libp2p_pubsub_tpu.ops import gossip as jgossip
from go_libp2p_pubsub_tpu.ops import gossip_packed as jgp
from go_libp2p_pubsub_tpu.ops import histogram as jhist
from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch import config as tcfg
from go_libp2p_pubsub_torch.crypto import native as tnative
from go_libp2p_pubsub_torch.crypto import vectors
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub as TG
from go_libp2p_pubsub_torch.models.gossipsub import build_topology
from go_libp2p_pubsub_torch.ops import bitpack as tbp
from go_libp2p_pubsub_torch.ops import gossip as tgossip
from go_libp2p_pubsub_torch.ops import gossip_packed as tgp
from go_libp2p_pubsub_torch.ops import histogram as thist
from go_libp2p_pubsub_torch.ops import rng as trng

import chip_smoke


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(port, ref, what):
    b = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    a = np.asarray(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=what)


def _state(seed, n=64, k=16, m=96, degree=8):
    """A random state as ``tests/test_gossip_packed.py`` makes its states:
    numpy planes (mesh symmetric over the slot pairing) and edge_live."""
    rng = np.random.default_rng(seed)
    nbrs, rev, valid, _ = build_topology(rng, n, k, degree)
    nbrs = nbrs.astype(np.int32)
    rev = rev.astype(np.int32)
    mesh = valid & (rng.random((n, k)) < 0.6)
    j = np.clip(nbrs, 0, n - 1)
    mesh = mesh & mesh[j, np.clip(rev, 0, k - 1)]
    alive = rng.random(n) < 0.9
    have = rng.random((n, m)) < 0.2
    fresh = have & (rng.random((n, m)) < 0.5)
    msg_valid = rng.random(m) < 0.8
    edge_live = valid & alive[j]
    return dict(mesh=mesh, nbrs=nbrs, rev=rev, valid=valid, alive=alive,
                have=have, fresh=fresh, msg_valid=msg_valid,
                edge_live=edge_live)


def _both(s, *names):
    return ([jnp.asarray(s[x]) for x in names],
            [torch.from_numpy(np.ascontiguousarray(s[x])) for x in names])


# -- the unpacked ops against the JAX package --------------------------------


@pytest.mark.parametrize("idontwant", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propagate_matches_reference(seed, idontwant):
    s = _state(seed)
    n, m = s["have"].shape
    first = np.full((n, m), -1, np.int32)
    first[np.random.default_rng(seed + 5).random((n, m)) < 0.1] = 3
    s["first_step"] = first
    names = ("mesh", "nbrs", "valid", "alive", "have", "fresh", "first_step",
             "msg_valid")
    ja, ta = _both(s, *names)
    # A pre-fold view that differs from ``have`` on the IDONTWANT arm.
    pre = s["have"] & (np.random.default_rng(seed).random((n, m)) < 0.5)
    kw_j = dict(idontwant=idontwant)
    kw_t = dict(idontwant=idontwant)
    if idontwant:
        kw_j["idw_have"] = jnp.asarray(pre)
        kw_t["idw_have"] = torch.from_numpy(pre)
    ref = jgossip.propagate(*ja, jnp.int32(7), **kw_j)
    out = tgossip.propagate(*ta, 7, **kw_t)
    assert type(out).__name__ == "PropagateOut"
    assert out._fields == ref._fields
    for name in ref._fields:
        _eq(getattr(out, name), getattr(ref, name), f"propagate.{name}")


@pytest.mark.parametrize("seed", [0, 3])
def test_ihave_advertise_and_iwant_select_match_reference(seed):
    s = _state(seed)
    n, k = s["nbrs"].shape
    rng = np.random.default_rng(seed)
    s["scores"] = rng.normal(0, 1, (n, k)).astype(np.float32)
    s["serve_ok"] = np.random.default_rng(seed + 99).random((n, k)) < 0.66
    s["uid"] = rng.permutation(n).astype(np.int32)
    ja, ta = _both(s, "have", "mesh", "nbrs", "rev", "edge_live", "alive",
                   "scores", "msg_valid")
    for uid in (None, "uid"):
        ju = None if uid is None else jnp.asarray(s[uid])
        tu = None if uid is None else torch.from_numpy(s[uid])
        jp, tp = jcfg.GossipSubParams(d_lazy=4), tcfg.GossipSubParams(d_lazy=4)
        ref_adv = jgossip.ihave_advertise(
            jax.random.PRNGKey(seed), *ja, jp, -0.5, uid=ju)
        adv = tgossip.ihave_advertise(
            trng.PRNGKey(seed), *ta, tp, -0.5, uid=tu)
        _eq(adv, ref_adv, f"ihave_advertise uid={uid}")
        assert adv.any()
        jb, tb = _both(s, "have", "edge_live", "scores", "serve_ok", "alive")
        ref_pend, ref_broken = jgossip.iwant_select(
            jax.random.PRNGKey(seed + 7), ref_adv, *jb,
            max_iwant_length=40, gossip_threshold=-0.5, uid=ju)
        pend, broken = tgossip.iwant_select(
            trng.PRNGKey(seed + 7), adv, *tb,
            max_iwant_length=40, gossip_threshold=-0.5, uid=tu)
        _eq(pend, ref_pend, f"iwant_select.pend uid={uid}")
        _eq(broken, ref_broken, f"iwant_select.broken uid={uid}")
        assert pend.any() and (broken > 0).any()


def _cap_rows(m=96):
    adv = np.ones((4, m), bool)
    adv[1, ::3] = False
    adv[2, :40] = False
    adv[3] = False
    return adv


@pytest.mark.parametrize("max_len", [31, 32, 33, 64, 65, 0, 1, 96])
def test_cap_ihave_matches_reference(max_len):
    adv = _cap_rows()
    ref = jgossip.cap_ihave(jnp.asarray(adv), max_len)
    out = tgossip.cap_ihave(torch.from_numpy(adv), max_len)
    _eq(out, ref, "cap_ihave")
    # A cube as the exchange caps it: [N, K, M] with a ragged last word.
    cube = np.random.default_rng(max_len).random((5, 3, 70)) < 0.6
    _eq(tgossip.cap_ihave(torch.from_numpy(cube), max_len),
        jgossip.cap_ihave(jnp.asarray(cube), max_len), "cap_ihave cube")


# -- the port's packed ops against its unpacked ops ---------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_packed_propagate_equals_unpacked(seed):
    s = _state(seed)
    n, m = s["have"].shape
    t = {x: torch.from_numpy(np.ascontiguousarray(v)) for x, v in s.items()}
    first = torch.full((n, m), -1, dtype=torch.int32)
    for idw in (False, True):
        ref = tgossip.propagate(
            t["mesh"], t["nbrs"], t["valid"], t["alive"], t["have"],
            t["fresh"], first, t["msg_valid"], 7, idontwant=idw)
        out = tgp.propagate_packed(
            t["mesh"], t["nbrs"], t["edge_live"], t["alive"],
            tbp.pack(t["have"]), tbp.pack(t["fresh"]),
            tbp.pack(t["msg_valid"]), idontwant=idw)
        _eq(tbp.unpack(out.have_w, m), ref.have, "have")
        _eq(tbp.unpack(out.fresh_w, m), ref.fresh, "fresh")
        for name in ("fmd_inc", "mmd_inc", "invalid_inc"):
            _eq(getattr(out, name), getattr(ref, name), name)
        stamped = torch.where(tbp.unpack(out.new_w, m) & (first < 0),
                              torch.tensor(7, dtype=torch.int32), first)
        _eq(stamped, ref.first_step, "first_step")


@pytest.mark.parametrize("seed", [0, 3])
def test_port_packed_exchange_equals_unpacked(seed):
    """Advertise then select, phase by phase under the same keys, and the
    fused exchange (K2's plain version) against the unpacked chain."""
    s = _state(seed)
    n, k = s["nbrs"].shape
    m = s["have"].shape[1]
    rng = np.random.default_rng(seed)
    t = {x: torch.from_numpy(np.ascontiguousarray(v)) for x, v in s.items()}
    scores = torch.from_numpy(rng.normal(0, 1, (n, k)).astype(np.float32))
    serve_ok = torch.from_numpy(rng.random((n, k)) < 0.66)
    dedup = t["have"] & torch.from_numpy(rng.random((n, m)) < 0.9)
    p = tcfg.GossipSubParams(d_lazy=4)
    ka, ki = trng.PRNGKey(seed), trng.PRNGKey(seed + 100)
    adv = tgossip.ihave_advertise(
        ka, t["have"], t["mesh"], t["nbrs"], t["rev"], t["edge_live"],
        t["alive"], scores, t["msg_valid"], p, -0.5)
    adv_w = tgp.ihave_advertise_packed(
        ka, tbp.pack(t["have"]), t["mesh"], t["nbrs"], t["rev"],
        t["edge_live"], t["alive"], scores, tbp.pack(t["msg_valid"]), p,
        -0.5)
    _eq(tbp.unpack(adv_w, m), adv, "advertise")
    pend, broken = tgossip.iwant_select(
        ki, adv, dedup, t["edge_live"], scores, serve_ok, t["alive"],
        max_iwant_length=40, gossip_threshold=-0.5)
    pend_w, broken_w = tgp.iwant_select_packed(
        ki, adv_w, tbp.pack(dedup), t["edge_live"], scores, serve_ok,
        t["alive"], max_iwant_length=40, gossip_threshold=-0.5)
    _eq(tbp.unpack(pend_w, m), pend, "select.pend")
    _eq(broken_w, broken, "select.broken")
    fpend, fbroken = tgp.gossip_exchange_packed(
        ka, ki, tbp.pack(t["have"]), tbp.pack(dedup), t["mesh"], t["nbrs"],
        t["rev"], t["edge_live"], t["alive"], scores,
        tbp.pack(t["msg_valid"]), p, -0.5, serve_ok, 40)
    _eq(tbp.unpack(fpend, m), pend, "exchange.pend")
    _eq(fbroken, broken, "exchange.broken")


@pytest.mark.parametrize("max_len", [31, 32, 33, 64, 65, 0, 1, 96])
def test_port_packed_cap_equals_unpacked(max_len):
    adv = torch.from_numpy(_cap_rows())
    ref = tgossip.cap_ihave(adv, max_len)
    out = tbp.unpack(tgp.cap_ihave_packed(tbp.pack(adv), max_len), 96)
    _eq(out, ref, "cap")
    assert (ref.sum(dim=1) <= max_len).all()


def test_full_is_the_all_ones_word():
    assert tgp.FULL == -1
    assert np.int32(tgp.FULL).view(np.uint32) == np.asarray(jgp.FULL)


def test_chip_smoke_oracle_holds_the_plain_versions_on_cpu():
    """Phase ``oracle``'s holds on its 589-peer state, the plain versions
    standing in for K1/K2 on CPU tensors: every cell equal, the round
    delivering and every exchange advertising; a changed cell fails."""
    orc = chip_smoke._Oracle()
    k1, k2s = chip_smoke.oracle_small("cpu")
    assert chip_smoke.oracle_k1(orc, k1, "589")
    assert all(chip_smoke.oracle_k2(orc, x, "589") for x in k2s)
    n, k, m = 589, 16, 96
    assert orc.cells["K1"]["have"] == {"cells": 2 * n * m, "mismatches": 0}
    assert orc.cells["K1"]["mmd_inc"]["cells"] == 2 * n * k
    assert orc.cells["K2"]["pend"] == {
        "cells": len(chip_smoke.ORACLE_SMALL_CAPS) * n * m, "mismatches": 0}
    out = torch.zeros(3, dtype=torch.float32)
    ref = out.clone()
    ref[1] = -0.0
    with pytest.raises(SystemExit):
        orc.hold("K2", "broken", out, ref, "a sign bit")


# -- GossipSub.run and masked_mean --------------------------------------------


def test_run_matches_reference_and_bare_rollout():
    kw = dict(n_peers=96, n_slots=16, conn_degree=12, msg_window=32)
    ga, gt = JG(use_pallas=False, **kw), TG(device="cpu", **kw)
    sa = ga.init(seed=4)
    st = bridge.state_from_jax(sa, device="cpu")
    for i in range(4):
        sa = ga.publish(sa, jnp.int32(i * 11), jnp.int32(i),
                        jnp.asarray(i != 1))
        st = gt.publish(st, i * 11, i, i != 1)
    ra = ga.run(sa, 9)
    rt = gt.run(st, 9)
    bare, record = gt.rollout(st, 9, record=False)
    assert record is None
    la = jax.tree.leaves(ra)
    lt = jax.tree.leaves(bridge.state_to_numpy(rt))
    lb = jax.tree.leaves(bridge.state_to_numpy(bare))
    assert len(la) == len(lt) == len(lb)
    for i, (a, b, c) in enumerate(zip(la, lt, lb)):
        _eq(np.asarray(b), a, f"run leaf {i}")
        _eq(np.asarray(c), np.asarray(b), f"rollout leaf {i}")


@pytest.mark.parametrize("case", ["random", "wide", "empty"])
def test_masked_mean_matches_reference(case):
    rng = np.random.default_rng(len(case))
    shape = (300, 16) if case != "wide" else (70, 40)
    x = (rng.normal(0, 3, shape)).astype(np.float32)
    mask = rng.random(shape) < (0.0 if case == "empty" else 0.3)
    ref = jax.jit(JG.masked_mean)(jnp.asarray(x), jnp.asarray(mask))
    out = TG.masked_mean(torch.from_numpy(x), torch.from_numpy(mask))
    _eq(out, ref, "masked_mean")
    _eq(out, JG.masked_mean(jnp.asarray(x), jnp.asarray(mask)),
        "masked_mean eager")


# -- masked_quantiles ---------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_masked_quantiles_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 3000))
    values = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 5)).astype(
        np.float32)
    if seed == 5:
        values = rng.integers(0, 50, n).astype(np.float32)
    mask = rng.random(n) < rng.random()
    for qs in ((0.5,), (0.1, 0.5, 0.9), tuple(rng.random(9)), (0.0, 1.0),
               (0.99,)):
        ref = jhist.masked_quantiles(jnp.asarray(values), jnp.asarray(mask),
                                     qs)
        out = thist.masked_quantiles(torch.from_numpy(values),
                                     torch.from_numpy(mask), qs)
        _eq(out, ref, f"masked_quantiles {qs}")


def test_masked_quantiles_degenerate_inputs():
    values = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    qs = (0.1, 0.5, 0.9)
    nothing = np.zeros(1000, bool)
    out = thist.masked_quantiles(torch.from_numpy(values),
                                 torch.from_numpy(nothing), qs)
    assert torch.isnan(out).all()
    _eq(out, jhist.masked_quantiles(jnp.asarray(values),
                                    jnp.asarray(nothing), qs), "empty")
    const = np.full(16, 2.5, np.float32)
    every = np.ones(16, bool)
    out = thist.masked_quantiles(torch.from_numpy(const),
                                 torch.from_numpy(every), qs)
    assert (out == 2.5).all()
    _eq(out, jhist.masked_quantiles(jnp.asarray(const), jnp.asarray(every),
                                    qs), "constant")


# -- config serialisation -----------------------------------------------------

CONFIGS = ("TreeOpts", "RetryOpts", "SimParams", "GossipSubParams",
           "ScoreParams")


@pytest.mark.parametrize("name", CONFIGS)
def test_to_json_matches_reference(name):
    jc, tc = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert tcfg.to_json(tc) == jcfg.to_json(jc)


def test_to_json_of_changed_fields_matches_reference():
    kw = dict(d=7, d_hi=13, idontwant=True, gossip_factor=0.5)
    assert (tcfg.to_json(tcfg.GossipSubParams(**kw))
            == jcfg.to_json(jcfg.GossipSubParams(**kw)))


def test_tree_opts_from_dict_matches_reference():
    d = dataclasses.asdict(tcfg.TreeOpts())
    assert tcfg.tree_opts_from_dict(d) == tcfg.TreeOpts()
    d.update(tree_width=3, tree_max_width=7)
    assert (dataclasses.asdict(tcfg.tree_opts_from_dict(d))
            == dataclasses.asdict(jcfg.tree_opts_from_dict(d)))
    with pytest.raises(TypeError):
        tcfg.tree_opts_from_dict(dict(d, no_such_field=1))


# -- native single-message calls ----------------------------------------------


def test_native_sha512_matches_hashlib():
    for msg in (b"", b"abc", b"q" * 111, b"w" * 112, b"e" * 127, b"r" * 128,
                b"t" * 9999):
        assert tnative.sha512(msg) == hashlib.sha512(msg).digest()
        assert tnative.sha512(msg) == jnative.sha512(msg)


def test_native_verify_on_rfc8032_vectors():
    pks, msgs, sigs, want = vectors.rfc8032_batch()
    got = [tnative.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert got == list(want)
    assert got == [jnative.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    tampered = bytes([sigs[2][40] ^ 0x10])
    assert not tnative.verify(pks[2], msgs[2],
                              sigs[2][:40] + tampered + sigs[2][41:])
    assert not tnative.verify(pks[2], msgs[2] + b"x", sigs[2])
    # Short authenticators are a defined reject, never a read past them.
    assert not tnative.verify(pks[0], msgs[0], sigs[0][:63])
    assert not tnative.verify(pks[0][:31], msgs[0], sigs[0])
