"""Signature vectors for holding the ed25519 verifiers against each other.

- :data:`RFC8032` and :func:`rfc8032_batch`: the four RFC 8032 §7.1 test
  vectors plus two corrupted rows (the JAX package's test data, copied);
- :func:`corruption_sweep`: a seeded batch signed by the native library
  that reaches every accept and reject path of a verifier: valid rows,
  flipped bits in R, S and the public key, altered messages, malleable
  ``S + L``, non-canonical ``y >= p``, the ``-0`` encoding, a ``y`` with no
  square root, small-order A and R, and the identity key with the
  ``(identity, 0)`` signature, which a non-cofactored verify accepts for
  any message.

``chip_smoke.py`` and the tests use them; verdicts come from the
verifiers, never from this module.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from . import ed25519_ref as ref

# RFC 8032 §7.1 test vectors: (secret, public, msg, sig), hex.
RFC8032 = [
    (  # TEST 1 (empty message)
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (  # TEST 2 (one byte)
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (  # TEST 3 (two bytes)
        "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
    (  # TEST SHA(abc)
        "833fe62409237b9d62ec77587520911e9a759cec1d19755b7da901b96dca3d42",
        "ec172b93ad5e563bf4932c70e1245034c35467ef2efd4d64ebf819683467e2bf",
        "ddaf35a193617abacc417349ae20413112e6fa4e89a97ea20a9eeee64b55d39a"
        "2192992a274fc1a836ba3c23a3feebbd454d4423643ce80e2a9ac94fa54ca49f",
        "dc2a4459e7369633a52b1bf277839a00201009a3efbf3ecb69bea2186c26b589"
        "09351fc9ac90b3ecfdfbc7c66431e0303dca179c138ac17ad9bef1177331a704",
    ),
]


def rfc8032_batch() -> Tuple[List[bytes], List[bytes], List[bytes], np.ndarray]:
    """The four §7.1 vectors plus two corrupted rows (flipped sig bit,
    flipped pubkey bit) -> (pks, msgs, sigs, want)."""
    pks, msgs, sigs = [], [], []
    for _, pk_h, msg_h, sig_h in RFC8032:
        pks.append(bytes.fromhex(pk_h))
        msgs.append(bytes.fromhex(msg_h))
        sigs.append(bytes.fromhex(sig_h))
    pks.append(pks[0])
    msgs.append(msgs[0])
    sigs.append(bytes([sigs[0][0] ^ 1]) + sigs[0][1:])
    pks.append(bytes([pks[1][0] ^ 1]) + pks[1][1:])
    msgs.append(msgs[1])
    sigs.append(sigs[1])
    return pks, msgs, sigs, np.array([True] * 4 + [False] * 2)


def _enc(y: int, sign: int) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


@functools.lru_cache(maxsize=None)
def small_order_encodings() -> Tuple[bytes, ...]:
    """The encodings of the eight points of order dividing 8 (the curve's
    torsion), found as [L]Q for points Q from a fixed seed."""
    rng = np.random.default_rng(8)
    found = {ref.point_compress(ref.IDENT)}
    while len(found) < 8:
        try:
            q = ref.point_decompress(rng.bytes(32))
        except ValueError:
            continue
        found.add(ref.point_compress(ref.point_mul(ref.L, q)))
    return tuple(sorted(found))


def no_root_encodings(count: int, seed: int) -> List[bytes]:
    """``count`` canonical encodings (y < p) whose x^2 = u/v has no square
    root, so decompression must reject them."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        y = int.from_bytes(rng.bytes(32), "little") & ((1 << 255) - 1)
        if y >= ref.P:
            continue
        try:
            ref.point_decompress(_enc(y, 0))
        except ValueError:
            out.append(_enc(y, int(rng.integers(2))))
    return out


KINDS = (
    "valid", "valid", "valid", "flip_r", "flip_s", "alter_msg", "flip_pk",
    "malleable_s", "r_y_ge_p", "a_y_ge_p", "minus_zero", "no_root",
    "small_order_a", "small_order_r", "identity_key", "valid",
)


def corruption_sweep(n: int, seed: int) -> Tuple[List[bytes], List[bytes],
                                                 List[bytes], List[str]]:
    """``n`` rows signed by the native library, row i corrupted as
    ``KINDS[i % 16]`` -> (pks, msgs, sigs, kinds)."""
    from . import native

    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(int(rng.integers(0, 200))) for _ in range(n)]
    pks = native.public_key_batch(seeds)
    sigs = native.sign_batch(seeds, msgs)
    torsion = small_order_encodings()
    no_root = iter(no_root_encodings(-(-n // 16), seed))
    kinds = []
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        kinds.append(kind)
        pk, msg, sig = pks[i], msgs[i], sigs[i]
        r, s = bytearray(sig[:32]), bytearray(sig[32:])
        if kind == "flip_r":
            r[rng.integers(32)] ^= 1 << int(rng.integers(8))
        elif kind == "flip_s":
            s[rng.integers(31)] ^= 1 << int(rng.integers(8))
        elif kind == "alter_msg":
            msg = msg + b"\x00" if rng.integers(2) else b"!" + msg
        elif kind == "flip_pk":
            b = bytearray(pk)
            b[rng.integers(32)] ^= 1 << int(rng.integers(8))
            pk = bytes(b)
        elif kind == "malleable_s":
            s = bytearray((int.from_bytes(s, "little") + ref.L).to_bytes(
                32, "little"))
        elif kind == "r_y_ge_p":
            r = bytearray(_enc(ref.P + int(rng.integers(19)),
                               int(rng.integers(2))))
        elif kind == "a_y_ge_p":
            pk = _enc(ref.P + int(rng.integers(19)), int(rng.integers(2)))
        elif kind == "minus_zero":  # x = 0 (y = 1 or y = -1) with sign 1
            enc = _enc(1 if rng.integers(2) else ref.P - 1, 1)
            if rng.integers(2):
                pk = enc
            else:
                r = bytearray(enc)
        elif kind == "no_root":
            if rng.integers(2):
                pk = next(no_root)
            else:
                r = bytearray(next(no_root))
        elif kind == "small_order_a":
            pk = torsion[rng.integers(8)]
        elif kind == "small_order_r":
            r = bytearray(torsion[rng.integers(8)])
            if rng.integers(2):
                pk = torsion[rng.integers(8)]
                s = bytearray(32)
        elif kind == "identity_key":  # accepted by a non-cofactored verify
            pk = ref.point_compress(ref.IDENT)
            r, s = bytearray(pk), bytearray(32)
        pks[i], msgs[i], sigs[i] = pk, msg, bytes(r) + bytes(s)
    return pks, msgs, sigs, kinds
