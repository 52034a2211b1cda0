"""Pure-Python ed25519 (RFC 8032) — the port's correctness oracle.

Its code is a verbatim copy of the JAX package's ``crypto/ed25519_ref.py``
(hashlib only), which the port keeps so that it imports nothing of that
package.
The device verifier's constants (``ops/ed25519.py``) and the host comb for
its fixed-base table come from here.  Implementations that share these
semantics in the port:

1. this one — slow, obviously-correct big-int Python; signs test traffic and
   cross-checks the others;
2. ``native.py`` — the C++ batch verifier (host data plane);
3. ``ops/ed25519.py`` — the limb-arithmetic batch verifier (its plain
   PyTorch version) and ``csrc/ed25519_verify.cu`` (its CUDA kernel).

Verification is **non-cofactored**: accept iff ``[S]B == R + [k]A`` with
``k = SHA512(R || A || M) mod L``, the check OpenSSL/ref10 perform.  Malleable
signatures are rejected by requiring ``S < L``.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P  # curve constant -121665/121666

# Base point: y = 4/5, x recovered even.
_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int:
    """x from y on -x^2 + y^2 = 1 + d x^2 y^2; raises if y is not on curve."""
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        if sign:
            raise ValueError("invalid point encoding")
        return 0
    # sqrt via x = x2^((p+3)/8); p = 5 mod 8
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P != 0:
        raise ValueError("not a square: invalid point encoding")
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
BASE = (_BX, _BY, 1, _BX * _BY % P)  # extended coordinates (X, Y, Z, T)
IDENT = (0, 1, 1, 0)


def point_add(p1, p2):
    """Extended-coordinates addition (complete formula for twisted Edwards)."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_mul(s: int, p) -> Tuple[int, int, int, int]:
    q = IDENT
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        s >>= 1
    return q


def point_equal(p1, p2) -> bool:
    x1, y1, z1, _ = p1
    x2, y2, z2, _ = p2
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def point_compress(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(b: bytes):
    if len(b) != 32:
        raise ValueError("point must be 32 bytes")
    enc = int.from_bytes(b, "little")
    y = enc & ((1 << 255) - 1)
    if y >= P:
        raise ValueError("y >= p: invalid point encoding")
    x = _recover_x(y, enc >> 255)
    return (x, y, 1, x * y % P)


def _sha512_int(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


def secret_expand(secret: bytes) -> Tuple[int, bytes]:
    if len(secret) != 32:
        raise ValueError("secret key must be 32 bytes")
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(secret: bytes) -> bytes:
    a, _ = secret_expand(secret)
    return point_compress(point_mul(a, BASE))


def sign(secret: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(secret)
    pk = point_compress(point_mul(a, BASE))
    r = _sha512_int(prefix, msg) % L
    big_r = point_compress(point_mul(r, BASE))
    k = _sha512_int(big_r, pk, msg) % L
    s = (r + k * a) % L
    return big_r + int.to_bytes(s, 32, "little")


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Non-cofactored verify: ``[S]B == R + [k]A``, rejecting ``S >= L``."""
    if len(pk) != 32 or len(sig) != 64:
        return False
    try:
        a = point_decompress(pk)
        r = point_decompress(sig[:32])
    except ValueError:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False  # malleability rejection
    k = _sha512_int(sig[:32], pk, msg) % L
    return point_equal(point_mul(s, BASE), point_add(r, point_mul(k, a)))


def keypair(seed: bytes) -> Tuple[bytes, bytes]:
    """Deterministic (secret, public) from a 32-byte seed."""
    return seed, public_key(seed)
