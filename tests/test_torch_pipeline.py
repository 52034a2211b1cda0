"""The port's validation pipeline (``go_libp2p_pubsub_torch/crypto/
pipeline.py``) held against the JAX package's on the CPU: envelope bytes,
span keys, signing, and for the ``"native"``, ``"python"`` and ``"device"``
backends the verdicts, stats, callbacks, tracer stamps, metrics, the
malformed-envelope screen and ``drop_pending``.  The port's ``"device"``
backend runs the plain PyTorch verifier here (``device="cpu"``); without a
card its default ``device="cuda"`` raises after re-queueing."""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch.crypto import native as tnative
from go_libp2p_pubsub_torch.crypto import pipeline as tpipe
from go_libp2p_pubsub_torch.obs import spans as tspans
from go_libp2p_pubsub_tpu.crypto import pipeline as jpipe
from go_libp2p_pubsub_tpu.obs import spans as jspans


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain verifier is thousands of small ops; with several test
    workers on the same cores, torch's intra-op thread pools spin against
    each other and run it ~10x slower.  One thread per op keeps it fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """A duck-typed tracer and metrics registry that logs every call."""

    def __init__(self):
        self.calls = []

    def stamp(self, key, stage, **attrs):
        self.calls.append(("stamp", key, stage, sorted(attrs.items())))

    def close(self, key, status=None):
        self.calls.append(("close", key, status))

    def inc(self, name, value=1):
        self.calls.append(("inc", name, value))

    def gauge(self, name, value):
        # wall times differ run to run; the name and type are the contract
        self.calls.append(("gauge", name, type(value).__name__
                           if name.endswith("verify_s") else value))


def _envelopes(mod, n=7, seed=3):
    """n envelopes from one seed: signed, one replayed signature, one
    cross-topic replay, and two malformed (short key, short signature)."""
    rng = np.random.default_rng(seed)
    envs = [mod.sign_envelope(rng.bytes(32), "t", i, rng.bytes(10 + i),
                              backend="native") for i in range(n)]
    envs[1] = mod.Envelope(envs[1].topic, envs[1].seqno, envs[1].payload,
                           envs[0].pubkey, envs[0].signature)
    envs[2] = mod.Envelope("u", envs[2].seqno, envs[2].payload,
                           envs[2].pubkey, envs[2].signature)
    envs.append(mod.Envelope("t", 99, b"x", b"\x01" * 7, b"\x02" * 64))
    envs.append(mod.Envelope("t", 98, b"x", envs[0].pubkey, b"\x02" * 10))
    return envs


def _drive(mod, backend, **kw):
    rec, verdicts, ctx_verdicts = _Recorder(), [], []
    pipe = mod.ValidationPipeline(
        backend=backend, flush_threshold=4, tracer=rec, metrics=rec,
        on_verdict=lambda e, ok: verdicts.append((e.seqno, ok)),
        on_verdict_ctx=lambda e, ok, c: ctx_verdicts.append((e.seqno, ok, c)),
        **kw)
    for i, env in enumerate(_envelopes(mod)):
        # ctx: a (topic, src) routing tuple (spanned) or opaque state; the
        # fourth submit flushes (threshold), the rest wait for flush()
        pipe.submit(env, (i % 3, 100 + i) if i % 2 == 0 else f"opaque{i}")
    out = pipe.flush()
    return dict(
        out=[(e.to_wire(), ok) for e, ok in out],
        verdicts=verdicts, ctx=ctx_verdicts, stats=dict(pipe.stats),
        calls=rec.calls, pending=len(pipe.drop_pending()))


@pytest.mark.parametrize("backend", ["native", "python", "device"])
def test_pipeline_matches_reference(backend):
    kw = dict(device="cpu") if backend == "device" else {}
    port = _drive(tpipe, backend, **kw)
    ref = _drive(jpipe, backend)
    assert port == ref
    assert port["stats"] == {"validated": 9, "accepted": 5, "rejected": 4}
    assert [ok for _, ok in port["verdicts"]] == [
        True, False, False, True, True, True, True, False, False]


def test_envelope_bytes_and_span_keys_match_reference():
    rng = np.random.default_rng(0)
    for topic, seqno, payload in (("", 0, b""), ("bench", 7, rng.bytes(64)),
                                  ("τοπικ", 2**64 - 1, b"\x00\xff")):
        assert tpipe.signing_bytes(topic, seqno, payload) == \
            jpipe.signing_bytes(topic, seqno, payload)
        env = tpipe.Envelope(topic, seqno, payload, rng.bytes(32),
                             rng.bytes(64))
        ref = jpipe.Envelope(*[getattr(env, f) for f in (
            "topic", "seqno", "payload", "pubkey", "signature")])
        assert env.to_wire() == ref.to_wire()
        assert tpipe.Envelope.from_wire(ref.to_wire()) == env
        for ctx in ((1, 2), [3, 4], ("5", 6), (1, 2, 3), None, "x", ("a", 1)):
            assert tspans.envelope_span_key(payload, ctx) == \
                jspans.envelope_span_key(payload, ctx)
        assert tspans.content_hash(9, 8, payload) == \
            jspans.content_hash(9, 8, payload)
    # the native module re-exports the pipeline's definitions
    assert tnative.Envelope is tpipe.Envelope
    assert tnative.signing_bytes is tpipe.signing_bytes


@pytest.mark.parametrize("backend", ["python", "native", "auto"])
def test_sign_envelope_matches_reference(backend):
    seed = bytes(range(32))
    env = tpipe.sign_envelope(seed, "topic-x", 42, b"\x00\xffdata", backend)
    ref = jpipe.sign_envelope(seed, "topic-x", 42, b"\x00\xffdata", backend)
    assert env.to_wire() == ref.to_wire()
    assert tpipe.Envelope.from_wire(env.to_wire()) == env


@pytest.mark.parametrize("backend", ["native", "python", "device"])
def test_verify_envelopes_matches_reference(backend):
    envs = _envelopes(tpipe)[:4]
    jenvs = [jpipe.Envelope.from_wire(e.to_wire()) for e in envs]
    got = tpipe.verify_envelopes(envs, backend, device="cpu")
    np.testing.assert_array_equal(got, jpipe.verify_envelopes(jenvs, backend))


def test_device_backend_without_a_card_raises_and_requeues():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device backend runs there")
    envs = _envelopes(tpipe)[:3]
    pipe = tpipe.ValidationPipeline(backend="device", flush_threshold=100)
    for e in envs:
        pipe.submit(e)
    with pytest.raises((RuntimeError, AssertionError)):
        pipe.flush()
    assert pipe.stats["validated"] == 0
    assert pipe.drop_pending() == envs
    assert pipe.flush() == []


def test_unknown_backend_rejected_like_reference():
    for mod in (tpipe, jpipe):
        with pytest.raises(ValueError, match="unknown backend"):
            mod.ValidationPipeline(backend="gpu")
