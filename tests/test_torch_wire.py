"""The port's wire codec, base58 and logger held against the JAX package's.

``wire.py``, ``utils/base58.py`` and ``utils/log.py`` are copies of the
reference's framework-free modules; the pins below allow only the one
listed change (the reference's docstrings cite the upstream Go sources by
their checkout path, the port's by file name).  Both packages encode
every frame kind to the same bytes and decode each other's bytes.
"""

import os
import random
import re

import pytest

from go_libp2p_pubsub_torch import wire as twire
from go_libp2p_pubsub_torch.utils import base58 as tb58
from go_libp2p_pubsub_torch.utils import log as tlog
from go_libp2p_pubsub_tpu import wire as jwire
from go_libp2p_pubsub_tpu.utils import base58 as jb58
from go_libp2p_pubsub_tpu.utils import log as jlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference cites the upstream Go sources as ``<checkout>/pubsub.go``.
_UPSTREAM_CITE = re.compile(r"``/\w+/reference/")


def assert_copy(rel, cites=0, substitutions=()):
    """The port's ``rel`` equals the reference's, after ``cites`` upstream
    citations lose their checkout path and each (old, new) substitution
    replaces its one occurrence."""
    with open(os.path.join(REPO, "go_libp2p_pubsub_tpu", rel)) as f:
        ref = f.read()
    with open(os.path.join(REPO, "go_libp2p_pubsub_torch", rel)) as f:
        port = f.read()
    ref, n = _UPSTREAM_CITE.subn("``", ref)
    assert n == cites, rel
    for old, new in substitutions:
        assert ref.count(old) == 1, old
        ref = ref.replace(old, new)
    assert port == ref


@pytest.mark.parametrize("rel,cites", [
    ("wire.py", 1), ("utils/base58.py", 1), ("utils/log.py", 0)])
def test_module_is_a_copy_of_the_reference(rel, cites):
    assert_copy(rel, cites)


def test_package_exports_the_wire_names():
    import go_libp2p_pubsub_torch as tpkg

    for name in ("Message", "MessageType", "encode_message",
                 "decode_message", "MessageDecoder"):
        assert getattr(tpkg, name) is getattr(twire, name)


# -- golden bytes ---------------------------------------------------------------


def _frames(w):
    """One frame of every kind, each with and without the replay flag and
    with the failover and tracing extensions."""
    T = w.MessageType
    base = [
        dict(type=T.DATA, data=b"\x00\xffbinary\n"),
        dict(type=T.JOIN),
        dict(type=T.PART),
        dict(type=T.UPDATE, peers=["QmPeer"], tree_width=2, tree_max_width=5),
        dict(type=T.STATE, peers=["QmChild", "QmOther"], num_peers=3),
        dict(type=T.UPDATE, peers=["QmRoot"], tree_width=2, tree_max_width=5,
             epoch=2, successors=["QmA", "QmB"], roster=["QmA", "QmC"]),
        dict(type=T.DATA, data=b"hi", epoch=1, traced=True,
             clock_offset=-0.25),
        dict(type=T.DATA, data=b""),
    ]
    return [w.Message(**kw, replay=r) for kw in base for r in (False, True)]


def test_every_frame_kind_encodes_to_the_references_bytes():
    assert [int(t) for t in twire.MessageType] == [
        int(t) for t in jwire.MessageType] == [0, 1, 2, 3, 4]
    ours = [twire.encode_message(m) for m in _frames(twire)]
    theirs = [jwire.encode_message(m) for m in _frames(jwire)]
    assert ours == theirs
    assert len(set(ours)) == len(ours)
    assert ours[2] == b'{"Type":1}\n'
    assert ours[3] == b'{"Type":1,"replay":true}\n'


def test_each_package_decodes_the_others_bytes():
    for m, raw in zip(_frames(jwire),
                      [twire.encode_message(x) for x in _frames(twire)]):
        got = jwire.decode_message(raw)
        assert got == m
    for m, raw in zip(_frames(twire),
                      [jwire.encode_message(x) for x in _frames(jwire)]):
        got = twire.decode_message(raw)
        assert got == m
        assert twire.encode_message(got) == raw


def test_decoder_at_every_split_offset():
    frames = _frames(twire)
    stream = b"".join(jwire.encode_message(m) for m in _frames(jwire))
    for cut in range(len(stream) + 1):
        dec = twire.MessageDecoder()
        dec.feed(stream[:cut])
        got = []
        while (m := dec.next_message()) is not None:
            got.append(m)
        dec.feed(stream[cut:])
        got += list(dec)
        assert got == frames, cut


def test_decoder_on_random_chunking_agrees_with_the_reference():
    rng = random.Random(12)
    stream = b"".join(twire.encode_message(m) for m in _frames(twire)) * 3
    for _ in range(20):
        cuts = sorted(rng.sample(range(1, len(stream)), 9))
        pieces = [stream[a:b] for a, b in zip([0] + cuts, cuts + [None])]
        out = []
        for mod in (twire, jwire):
            dec = mod.MessageDecoder()
            for p in pieces:
                dec.feed(p)
            out.append([mod.encode_message(m) for m in dec])
        assert out[0] == out[1]
        assert len(out[0]) == 3 * len(_frames(twire))


# -- base58 -------------------------------------------------------------------


# The standard vectors of the reference's tests/test_base58.py.
VECTORS = [
    (b"", ""),
    (b"\x61", "2g"),
    (b"\x62\x62\x62", "a3gV"),
    (b"\x63\x63\x63", "aPEr"),
    (b"simply a long string", "2cFupjhnEsSn59qHXstmK2ffpLv2"),
    (bytes.fromhex("00eb15231dfceb60925886b67d065299925915aeb172c06647"),
     "1NS17iag9jJgTHD1VXjvLCEnZuQ3rJDE9L"),
    (bytes.fromhex("516b6fcd0f"), "ABnLTmg"),
    (bytes.fromhex("bf4f89001e670274dd"), "3SEo3LWLoPntC"),
    (bytes.fromhex("572e4794"), "3EFU7m"),
    (bytes.fromhex("ecac89cad93923c02321"), "EJDM8drfXA6uyA"),
    (bytes.fromhex("10c8511e"), "Rt5zm"),
    (b"\x00" * 10, "1111111111"),
]


@pytest.mark.parametrize("raw,encoded", VECTORS)
def test_base58_vectors_on_both_packages(raw, encoded):
    for b58 in (tb58, jb58):
        assert b58.b58encode(raw) == encoded
        assert b58.b58decode(encoded) == raw


def test_peer_ids_agree_with_the_reference():
    import hashlib

    rng = random.Random(5)
    for _ in range(20):
        pub = bytes(rng.randrange(256) for _ in range(32))
        pid = tb58.peer_id_from_ed25519_pub(pub)
        assert pid == jb58.peer_id_from_ed25519_pub(pub)
        assert pid.startswith("12D3KooW")
        assert tb58.ed25519_pub_from_peer_id(pid) == pub
        assert tb58.parse_peer_id(pid) == jb58.parse_peer_id(pid)
        qm = tb58.peer_id_from_sha256(hashlib.sha256(pub).digest())
        assert qm == jb58.peer_id_from_sha256(hashlib.sha256(pub).digest())
    ids = [tb58.peer_id_from_ed25519_pub(b"\x01" * 32), "not-base58-0", "",
           "QmtooShort"]
    assert tb58.transl_peer_ids(ids) == jb58.transl_peer_ids(ids) == ids[:1]
    for bad in ("", "abc0def", "livepeer-0"):
        with pytest.raises(ValueError):
            tb58.parse_peer_id(bad)


def test_logger_formats_like_the_reference():
    import logging

    assert tlog.get_logger("live").name == jlog.get_logger("live").name \
        == "pubsub.live"
    assert tlog.get_logger("pubsub.x").name == "pubsub.x"
    assert tlog.kv(a=1, b="x") == jlog.kv(a=1, b="x") == {
        "kv": {"a": 1, "b": "x"}}
    fmt = "%(levelname)s %(name)s: %(message)s"
    rec = logging.LogRecord("pubsub.live", logging.INFO, __file__, 1,
                            "join_admit", None, None)
    rec.kv = {"width": 2, "peer": "p1"}
    out = [mod._KVFormatter(fmt).format(rec) for mod in (tlog, jlog)]
    assert out[0] == out[1] == "INFO pubsub.live: join_admit peer=p1 width=2"
