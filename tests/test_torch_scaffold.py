"""The PyTorch port's scaffold held against the JAX package: config, bit
packing, the threefry PRNG, the graph helpers, and the port's independence
from JAX (a subprocess import with ``jax`` blocked, and a source scan).

Integer, bool and packed results are compared exactly; so are the PRNG's
floats (bit for bit)."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import config as jcfg
from go_libp2p_pubsub_tpu.ops import bitpack as jbp
from go_libp2p_pubsub_tpu.ops import graphs as jgr
from go_libp2p_pubsub_torch import config as tcfg
from go_libp2p_pubsub_torch.ops import bitpack as tbp
from go_libp2p_pubsub_torch.ops import graphs as tgr
from go_libp2p_pubsub_torch.ops import rng as trng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "go_libp2p_pubsub_torch")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# -- config -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["GossipSubParams", "ScoreParams"])
def test_config_fields_and_defaults_match_reference(name):
    ref, port = getattr(jcfg, name), getattr(tcfg, name)
    rf = [(f.name, f.type, f.default) for f in dataclasses.fields(ref)]
    pf = [(f.name, f.type, f.default) for f in dataclasses.fields(port)]
    assert rf == pf
    assert dataclasses.asdict(ref()) == dataclasses.asdict(port())


@pytest.mark.parametrize("bad", [
    dict(d=3, d_lo=4), dict(history_gossip=9), dict(d_out=4),
    dict(prune_backoff_heartbeats=-1), dict(opportunistic_graft_ticks=0),
    dict(max_iwant_length=0),
])
def test_gossip_params_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        jcfg.GossipSubParams(**bad)
    with pytest.raises(ValueError):
        tcfg.GossipSubParams(**bad)


def test_score_params_validation_matches_reference():
    bad = dict(mesh_message_deliveries_weight=-1.0,
               mesh_message_deliveries_threshold=0.0)
    with pytest.raises(ValueError):
        jcfg.ScoreParams(**bad)
    with pytest.raises(ValueError):
        tcfg.ScoreParams(**bad)


# -- bitpack ----------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 31, 32, 64, 100, 128])
def test_bitpack_matches_reference(m):
    rng = np.random.default_rng(m)
    flags = rng.random((7, 5, m)) < 0.4
    jw = np.asarray(jbp.pack(jnp.asarray(flags)))
    tw = tbp.pack(torch.from_numpy(flags))
    np.testing.assert_array_equal(_u32(tw), jw)
    np.testing.assert_array_equal(tbp.pack_np(flags), jbp.pack_np(flags))
    np.testing.assert_array_equal(
        tbp.unpack(tw, m).numpy(), np.asarray(jbp.unpack(jnp.asarray(jw), m)))
    np.testing.assert_array_equal(
        tbp.popcount(tw).numpy(), np.asarray(jbp.popcount(jnp.asarray(jw))))
    for slot in {0, m // 2, m - 1}:
        np.testing.assert_array_equal(
            tbp.get_bit(tw, slot).numpy(),
            np.asarray(jbp.get_bit(jnp.asarray(jw), slot)))
        np.testing.assert_array_equal(
            _u32(tbp.bit_mask(slot, jw.shape[-1])),
            np.asarray(jbp.bit_mask(jnp.int32(slot), jw.shape[-1])))


def test_popcount_of_every_bit_pattern_class():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0xAAAAAAAA,
                      0x0F0F0F0F, 0x12345678, 0xDEADBEEF], np.uint32)
    rng = np.random.default_rng(0)
    words = np.concatenate([words, rng.integers(0, 2**32, 4096, np.uint32)])
    t = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(
        tbp.popcount_words(t).numpy(),
        np.asarray(jax.lax.population_count(jnp.asarray(words))).astype(
            np.int32))
    for s in (0, 1, 7, 31):
        np.testing.assert_array_equal(_u32(tbp.srl(t, s)), words >> s)


# -- rng --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, 2**32 - 1])
def test_prng_key_and_split_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = trng.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    for num in (2, 3, 6):
        np.testing.assert_array_equal(
            _u32(trng.split(tk, num)), np.asarray(jax.random.split(jk, num)))
    # Chains of splits stay identical.
    a, b = trng.split(tk, 2).unbind(0)
    ja, jb = jax.random.split(jk, 2)
    np.testing.assert_array_equal(
        _u32(trng.split(b, 3)), np.asarray(jax.random.split(jb, 3)))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (13, 17), (2, 3, 4)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.0, 1e-3), (-2.5, 3.0)])
def test_uniform_matches_jax_bit_for_bit(shape, bounds):
    lo, hi = bounds
    jk = jax.random.split(jax.random.PRNGKey(42), 3)[2]
    tk = trng.split(trng.PRNGKey(42), 3)[2]
    ref = jax.jit(lambda k: jax.random.uniform(
        k, shape, minval=lo, maxval=hi))(jk)
    out = trng.uniform(tk, shape, minval=lo, maxval=hi)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_array_equal(
        out.numpy().view(np.int32), np.asarray(ref).view(np.int32))


# -- graphs -----------------------------------------------------------------


def test_index_dtype_and_plane_codec_match_reference():
    for n in (0, 1, 100, 65533, 65534, 65535, 100_000):
        assert tgr.index_dtype(n) == jgr.index_dtype(n)
    rng = np.random.default_rng(3)
    plane = rng.integers(-1, 500, (40, 9))
    enc_t, enc_j = tgr.encode_index_plane(plane, 500), jgr.encode_index_plane(
        plane, 500)
    assert enc_t.dtype == enc_j.dtype == np.uint16
    np.testing.assert_array_equal(enc_t, enc_j)
    t = torch.from_numpy(enc_t)
    np.testing.assert_array_equal(
        tgr.decode_index_plane(t).numpy(), jgr.decode_index_plane(enc_j))
    np.testing.assert_array_equal(
        tgr.narrow_index_plane(tgr.decode_index_plane(t), torch.uint16)
        .numpy(), enc_j)
    with pytest.raises(ValueError):
        tgr.encode_index_plane(np.array([500]), 500)


def test_graph_helpers_match_reference():
    rng = np.random.default_rng(5)
    n, k = 300, 16
    targets = rng.integers(0, 40, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    np.testing.assert_array_equal(
        tgr.segment_rank(torch.from_numpy(targets),
                         torch.from_numpy(mask)).numpy(),
        np.asarray(jgr.segment_rank(jnp.asarray(targets), jnp.asarray(mask))))
    vals = rng.integers(0, 5, (n, k)).astype(np.int32)   # many ties
    vmask = rng.random((n, k)) < 0.5
    np.testing.assert_array_equal(
        tgr.masked_argmin(torch.from_numpy(vals),
                          torch.from_numpy(vmask)).numpy(),
        np.asarray(jgr.masked_argmin(jnp.asarray(vals), jnp.asarray(vmask))))
    table = rng.normal(size=(n, 3)).astype(np.float32)
    idx = rng.integers(-1, n, (n, k)).astype(np.int32)
    np.testing.assert_array_equal(
        tgr.safe_gather(torch.from_numpy(table), torch.from_numpy(idx),
                        7.0).numpy(),
        np.asarray(jgr.safe_gather(jnp.asarray(table), jnp.asarray(idx), 7.0)))
    # top_mask with ties, -inf entries, a static count and a per-row quota.
    scores = np.round(rng.normal(size=(n, k)), 1).astype(np.float32)
    scores[rng.random((n, k)) < 0.3] = -np.inf
    count = rng.integers(0, 7, n).astype(np.int32)
    for c, kmax in ((3, None), (count, 6)):
        ref = jgr.top_mask(jnp.asarray(scores),
                           c if isinstance(c, int) else jnp.asarray(c), kmax)
        out = tgr.top_mask(torch.from_numpy(scores),
                           c if isinstance(c, int) else torch.from_numpy(c),
                           kmax)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    row = rng.random(12) < 0.5
    for r in range(14):
        assert int(tgr.nth_free_slot(torch.from_numpy(row), r)) == int(
            jgr.nth_free_slot(jnp.asarray(row), jnp.int32(r)))


# -- independence from JAX --------------------------------------------------


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import go_libp2p_pubsub_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'go_libp2p_pubsub_tpu' not in sys.modules\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|go_libp2p_pubsub_tpu)\b", re.M)
_DYNAMIC = re.compile(
    r"(import_module|__import__)\(\s*[\"'](jax|go_libp2p_pubsub_tpu)")


def test_port_sources_never_import_jax_or_the_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not _FORBIDDEN.search(src), path
        assert not _DYNAMIC.search(src), path


# -- native ed25519 binding -------------------------------------------------


def test_native_binding_matches_reference():
    """The port's copy of the ctypes binding (its own g++ build of the
    shared source) signs, derives keys and verifies exactly as the
    reference's, and its envelope format is the reference's."""
    from go_libp2p_pubsub_tpu.crypto import native as jnative
    from go_libp2p_pubsub_tpu.crypto import pipeline as jpipe
    from go_libp2p_pubsub_torch.crypto import native as tnative

    rng = np.random.default_rng(1)
    seeds = [rng.bytes(32) for _ in range(12)]
    payloads = [rng.bytes(40) for _ in range(12)]
    msgs = [tnative.signing_bytes("bench", i, p) for i, p in enumerate(payloads)]
    assert msgs == [jpipe.signing_bytes("bench", i, p)
                    for i, p in enumerate(payloads)]
    pks = tnative.public_key_batch(seeds)
    sigs = tnative.sign_batch(seeds, msgs)
    assert pks == jnative.public_key_batch(seeds)
    assert sigs == jnative.sign_batch(seeds, msgs)
    forged = {2, 7}
    checked = [m if i not in forged else bytes([m[0] ^ 1]) + m[1:]
               for i, m in enumerate(msgs)]
    verdicts = tnative.verify_batch(pks, checked, sigs)
    np.testing.assert_array_equal(verdicts,
                                  jnative.verify_batch(pks, checked, sigs))
    assert [i for i, ok in enumerate(verdicts) if not ok] == sorted(forged)
    env = tnative.Envelope("bench", 3, payloads[3], pks[3], sigs[3])
    ref = jpipe.Envelope("bench", 3, payloads[3], pks[3], sigs[3])
    assert env.to_wire() == ref.to_wire()
    assert tnative.Envelope.from_wire(ref.to_wire()) == env
