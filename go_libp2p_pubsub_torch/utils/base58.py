"""base58btc codec + libp2p-style peer-id helpers.

The reference's ``translPeerIDs`` (``subtree.go:228-239``)
decodes the base58 peer-id strings carried in ``Message.Peers`` into
``peer.ID`` values before dialing them, erroring on malformed entries.  The
live plane keeps peer ids as opaque strings (``net/transport.Peerstore``),
so the equivalent boundary is validation: :func:`transl_peer_ids` filters a
wire-carried candidate list down to well-formed ids, and :class:`Peerstore`
construction can opt into strict ids (``validate_ids=True`` there).

Formats (the two libp2p peer-id shapes in the wild):

- sha256 multihash ids: ``0x12 0x20 || digest32`` -> base58 starts "Qm";
- identity multihash ids of an ed25519 public key protobuf:
  ``0x00 0x24 || 0x08 0x01 0x12 0x20 || pub32`` -> base58 starts "12D3KooW".
"""

from __future__ import annotations

from typing import List, Optional

ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(ALPHABET)}

# multihash codes (the two used by libp2p peer ids)
MH_IDENTITY = 0x00
MH_SHA2_256 = 0x12
# ed25519 public-key protobuf header: field 1 (KeyType) = 1 (Ed25519),
# field 2 (Data) length 32.
ED25519_PB_PREFIX = b"\x08\x01\x12\x20"


def b58encode(raw: bytes) -> str:
    """base58btc encode (Bitcoin alphabet, leading zero bytes -> '1's)."""
    n_zeros = len(raw) - len(raw.lstrip(b"\x00"))
    num = int.from_bytes(raw, "big")
    out = []
    while num > 0:
        num, rem = divmod(num, 58)
        out.append(ALPHABET[rem])
    return "1" * n_zeros + "".join(reversed(out))


def b58decode(s: str) -> bytes:
    """base58btc decode; raises ``ValueError`` on characters outside the
    alphabet (0, O, I, l are excluded by design)."""
    num = 0
    for c in s:
        try:
            num = num * 58 + _INDEX[c]
        except KeyError:
            raise ValueError(f"invalid base58 character {c!r}") from None
    n_zeros = len(s) - len(s.lstrip("1"))
    body = num.to_bytes((num.bit_length() + 7) // 8, "big") if num else b""
    return b"\x00" * n_zeros + body


def peer_id_from_sha256(digest: bytes) -> str:
    """sha256-multihash peer id ("Qm..." form) from a 32-byte digest."""
    if len(digest) != 32:
        raise ValueError(f"sha256 digest must be 32 bytes, got {len(digest)}")
    return b58encode(bytes([MH_SHA2_256, 32]) + digest)


def peer_id_from_ed25519_pub(pub: bytes) -> str:
    """identity-multihash peer id ("12D3KooW..." form) from a 32-byte
    ed25519 public key (inlined as the protobuf libp2p wraps keys in)."""
    if len(pub) != 32:
        raise ValueError(f"ed25519 public key must be 32 bytes, got {len(pub)}")
    inner = ED25519_PB_PREFIX + pub
    return b58encode(bytes([MH_IDENTITY, len(inner)]) + inner)


def parse_peer_id(s: str) -> bytes:
    """Decode + validate a peer-id string -> its multihash bytes.

    The decode half of ``translPeerIDs``: raises ``ValueError`` for anything
    that is not a well-formed base58 multihash of a known shape.
    """
    raw = b58decode(s)
    if len(raw) < 2:
        raise ValueError(f"peer id too short: {s!r}")
    code, length = raw[0], raw[1]
    body = raw[2:]
    if len(body) != length:
        raise ValueError(
            f"peer id length mismatch: header says {length}, got {len(body)}"
        )
    if code == MH_SHA2_256:
        if length != 32:
            raise ValueError(f"sha256 peer id must carry 32 bytes, got {length}")
    elif code == MH_IDENTITY:
        if not body.startswith(ED25519_PB_PREFIX) or len(body) != 36:
            raise ValueError(f"identity peer id is not an ed25519 key: {s!r}")
    else:
        raise ValueError(f"unknown multihash code 0x{code:02x} in peer id {s!r}")
    return raw


def ed25519_pub_from_peer_id(s: str) -> Optional[bytes]:
    """The 32-byte ed25519 public key inlined in an identity peer id, or
    ``None`` for digest-form ids (key not recoverable from a hash)."""
    raw = parse_peer_id(s)
    if raw[0] == MH_IDENTITY:
        return raw[2 + len(ED25519_PB_PREFIX):]
    return None


def transl_peer_ids(peers: List[str]) -> List[str]:
    """Filter a wire-carried candidate-parent list to well-formed peer ids.

    ``translPeerIDs`` (``subtree.go:228-239``) fails the whole join on the
    first malformed id; dropping just the bad entries keeps the remaining
    candidates usable — a documented deviation (the join walk then tries the
    valid ones instead of aborting).
    """
    out = []
    for s in peers:
        try:
            parse_peer_id(s)
        except ValueError:
            continue
        out.append(s)
    return out
