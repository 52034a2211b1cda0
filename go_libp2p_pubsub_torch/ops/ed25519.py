"""Batched ed25519 verification: the plain PyTorch version of kernel E1.

The port of the JAX package's ``ops/ed25519.py``.  Same accept/reject
semantics as ``crypto/ed25519_ref.py`` (the Python oracle) and
``native/ed25519`` (the C++ host verifier): non-cofactored ``[S]B == R +
[k]A`` with ``k = SHA512(R||A||M) mod L``, rejecting ``S >= L`` and
non-canonical point encodings.  SHA-512, ``k mod L`` and the byte-level
canonicity checks run on the host; decompression, the ladder and the
projective compare run on the device.

Two implementations of the device part, verdict-identical:

- this module, the plain version ("the twin"): the JAX package's
  batch-major functions op for op, in the same representation -- field
  elements of GF(2^255-19) as **22 signed int32 limbs of 12 bits**
  (``[LIMBS, B]``, limbs lead), the fold constant ``2^264 mod p = 9728``,
  extended twisted-Edwards points, the complete addition and the dedicated
  doubling.  Every intermediate equals the JAX package's limb for limb.
  PyTorch has no integer matrix product on CUDA, so the limb convolution
  is a float64 product against the one-hot tensor: each term is < 2^24 and
  a sum of at most 22 of them < 2^30, exact in float64's 53 bits.
- ``csrc/ed25519_verify.cu`` (kernel E1, wrapped in ``ops/cuda_ed25519.py``):
  one thread per signature in radix-2^51 arithmetic.

:func:`verify_batch` takes ``device=`` (default ``"cuda"``): on the CPU it
runs the twin, on a CUDA device it launches E1 or raises.  The JAX
package's row-major kernels exist only for the TPU's lane axis, so
``batch_major=False`` runs the same (batch-major) twin or kernel here.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..crypto.ed25519_ref import D as _D_INT, L as _L_INT, P as _P_INT, _BX, _BY
from ..utils.trace import span

LIMBS = 22
BITS = 12
RADIX = 1 << BITS
CONV = 2 * LIMBS - 1  # 43
FOLD = 9728  # 2^264 mod p = 19 * 2^9
ROW_BYTES = 128  # a device row: A | R | S | k, 32 bytes each

# ---------------------------------------------------------------------------
# host-side constants
# ---------------------------------------------------------------------------


def _int_to_limbs(v: int) -> np.ndarray:
    return np.array([(v >> (BITS * i)) & (RADIX - 1) for i in range(LIMBS)], np.int32)


_ONE_HOT = np.zeros((CONV, LIMBS, LIMBS), np.int32)
for _i in range(LIMBS):
    for _j in range(LIMBS):
        _ONE_HOT[_i + _j, _i, _j] = 1

FE_D = _int_to_limbs(_D_INT)
FE_2D = _int_to_limbs(2 * _D_INT % _P_INT)
FE_BX = _int_to_limbs(_BX)
FE_BY = _int_to_limbs(_BY)
FE_BT = _int_to_limbs(_BX * _BY % _P_INT)
FE_SQRT_M1 = _int_to_limbs(pow(2, (_P_INT - 1) // 4, _P_INT))
FE_P = _int_to_limbs(_P_INT)
_FE_512P = _int_to_limbs(512 * _P_INT)
_POW_EXP_BITS = np.array(  # (p-5)/8, MSB first — decompression square root
    [((_P_INT - 5) // 8 >> i) & 1 for i in reversed(range(253))], np.int32
)

_DEVICE_CONSTS: Dict[Tuple[str, str], torch.Tensor] = {}


def _on(name: str, make, device) -> torch.Tensor:
    """Device copy of a host constant, made once per device."""
    key = (name, str(torch.device(device)))
    if key not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[key] = make().to(device)
    return _DEVICE_CONSTS[key]


def _const_bm(limbs: np.ndarray, device) -> torch.Tensor:
    """Host limb vector [22] -> broadcastable [22, 1] device constant."""
    return _on(limbs.tobytes().hex(),
               lambda: torch.from_numpy(limbs.copy())[:, None], device)


def _one_hot_f64(device) -> torch.Tensor:
    """``_ONE_HOT`` as a [43, 484] float64 matrix (the exact convolution)."""
    return _on("one_hot", lambda: torch.from_numpy(
        _ONE_HOT.reshape(CONV, LIMBS * LIMBS).astype(np.float64)), device)


# ---------------------------------------------------------------------------
# batch-major field ops on [LIMBS, B] int32
# ---------------------------------------------------------------------------


def _carry_once_bm(x: torch.Tensor) -> torch.Tensor:
    """One ripple pass; the carry out of the top limb folds via 2^264 ≡ 9728.
    ``>>`` on int32 is an arithmetic shift, right for negative limbs."""
    c = x >> BITS
    lo = x - (c << BITS)
    out = lo + torch.cat([torch.zeros_like(c[:1]), c[:-1]], dim=0)
    out[0] += FOLD * c[-1]
    return out


def fe_norm_bm(x: torch.Tensor) -> torch.Tensor:
    """Restore |limb| < 2^12 (three passes converge from conv magnitude)."""
    x = _carry_once_bm(x)
    x = _carry_once_bm(x)
    return _carry_once_bm(x)


def fe_mul_bm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    outer = a[:, None, :] * b[None, :, :]  # [22, 22, B], < 2^24 each
    batch = outer.shape[2:]
    conv = (_one_hot_f64(outer.device)
            @ outer.reshape(LIMBS * LIMBS, -1).to(torch.float64))
    conv = conv.to(torch.int32).reshape((CONV,) + batch)
    lo, hi = conv[:LIMBS], conv[LIMBS:]
    hi = torch.cat([hi, torch.zeros_like(hi[:1])], dim=0)
    return fe_norm_bm(lo + FOLD * fe_norm_bm(hi))


def fe_sq_bm(a: torch.Tensor) -> torch.Tensor:
    return fe_mul_bm(a, a)


def fe_add_bm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry_once_bm(a + b)


def fe_sub_bm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry_once_bm(a - b)  # signed limbs: no bias needed


def fe_canon_bm(x: torch.Tensor) -> torch.Tensor:
    """Exact canonical form in [0, p): add 512p (= 2^264 - 9728) so the
    value is nonnegative, fold bits >= 255 twice, then subtract p once if
    the value is >= p, through a 22-step borrow ripple over the limbs."""
    x = fe_norm_bm(x)
    x = fe_norm_bm(x + _const_bm(_FE_512P, x.device))
    for _ in range(2):
        hi = x[21] >> 3
        x[21] += -(hi << 3)
        x[0] += 19 * hi
        x = _carry_once_bm(x)
        x = _carry_once_bm(x)
    borrow = torch.zeros_like(x[0])
    diffs = []
    for i in range(LIMBS):
        d = x[i] - int(FE_P[i]) + borrow
        b = (d < 0).to(torch.int32)
        borrow = -b
        diffs.append(d + (b << BITS))
    geq = borrow == 0  # no borrow out: x >= p
    return torch.where(geq[None], torch.stack(diffs), x)


def fe_is_zero_bm(x: torch.Tensor) -> torch.Tensor:
    return (fe_canon_bm(x) == 0).all(dim=0)


def fe_eq_bm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_is_zero_bm(fe_sub_bm(a, b))


def fe_parity_bm(x: torch.Tensor) -> torch.Tensor:
    return fe_canon_bm(x)[0] & 1


def fe_pow_const_bm(a: torch.Tensor, exp_bits_msb_first: np.ndarray) -> torch.Tensor:
    """a^e for a fixed public exponent, MSB-first square-and-multiply (the
    multiply is skipped where the bit is 0, as the JAX scan's select)."""
    r = torch.zeros_like(a)
    r[0] = 1
    for bit in np.asarray(exp_bits_msb_first).tolist():
        r = fe_sq_bm(r)
        if bit:
            r = fe_mul_bm(r, a)
    return r


# ---------------------------------------------------------------------------
# points: extended coordinates, each a [LIMBS, B] tensor
# ---------------------------------------------------------------------------


class Point(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def _point_map(fn, *points: Point) -> Point:
    return Point(*(fn(*coords) for coords in zip(*points)))


def pt_identity_bm(batch: int, device) -> Point:
    zero = torch.zeros((LIMBS, batch), dtype=torch.int32, device=device)
    one = zero.clone()
    one[0] = 1
    return Point(zero, one, one.clone(), zero.clone())


def pt_add_bm(p: Point, q: Point) -> Point:
    """Complete twisted-Edwards addition (the oracle's ``point_add``):
    valid for doubling and the identity, so the ladders need no branches."""
    a = fe_mul_bm(fe_sub_bm(p.y, p.x), fe_sub_bm(q.y, q.x))
    b = fe_mul_bm(fe_add_bm(p.y, p.x), fe_add_bm(q.y, q.x))
    c = fe_mul_bm(fe_mul_bm(p.t, q.t), _const_bm(FE_2D, p.t.device))
    zz = fe_mul_bm(p.z, q.z)
    d = fe_add_bm(zz, zz)
    e, f, g, h = (
        fe_sub_bm(b, a), fe_sub_bm(d, c), fe_add_bm(d, c), fe_add_bm(b, a)
    )
    return Point(
        fe_mul_bm(e, f), fe_mul_bm(g, h), fe_mul_bm(f, g), fe_mul_bm(e, h)
    )


def pt_dbl_bm(p: Point) -> Point:
    """Dedicated doubling (dbl-2008-hwcd, a = -1): 4 squarings + 4
    multiplications; equal to ``pt_add_bm(p, p)`` up to projective scale."""
    a = fe_sq_bm(p.x)
    b = fe_sq_bm(p.y)
    zz = fe_sq_bm(p.z)
    c = fe_add_bm(zz, zz)
    g = fe_sub_bm(b, a)
    f = fe_sub_bm(g, c)
    h = fe_sub_bm(fe_sub_bm(torch.zeros_like(a), a), b)
    e = fe_sub_bm(fe_sub_bm(fe_sq_bm(fe_add_bm(p.x, p.y)), a), b)
    return Point(
        fe_mul_bm(e, f), fe_mul_bm(g, h), fe_mul_bm(f, g), fe_mul_bm(e, h)
    )


def pt_neg_bm(p: Point) -> Point:
    zero = torch.zeros_like(p.x)
    return Point(fe_sub_bm(zero, p.x), p.y, p.z, fe_sub_bm(zero, p.t))


def pt_select_stacked_bm(stack: Point, idx: torch.Tensor) -> Point:
    """Table lookup against a stacked [n, LIMBS, B] table: row ``idx[b]`` of
    each coordinate for every batch column b (the JAX package's one-hot
    contraction picks the same limbs)."""
    index = idx.to(torch.int64).reshape(1, 1, -1).expand(1, LIMBS, -1)
    return _point_map(lambda s: s.gather(0, index)[0], stack)


def pt_eq_bm(p: Point, q: Point) -> torch.Tensor:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    return fe_eq_bm(fe_mul_bm(p.x, q.z), fe_mul_bm(q.x, p.z)) & fe_eq_bm(
        fe_mul_bm(p.y, q.z), fe_mul_bm(q.y, p.z)
    )


def pt_decompress_bm(
    y_limbs: torch.Tensor, sign: torch.Tensor
) -> Tuple[Point, torch.Tensor]:
    """Batch-major decompression: ``y_limbs`` [22, B'], ``sign`` [B'];
    returns (point, valid mask).  x = uv^3 (uv^7)^((p-5)/8) with u = y^2-1,
    v = d y^2+1, times sqrt(-1) when vx^2 == -u; the -0 encoding is
    invalid.  y < p is checked on the host."""
    dev = y_limbs.device
    one = torch.zeros_like(y_limbs)
    one[0] = 1
    y2 = fe_sq_bm(y_limbs)
    u = fe_sub_bm(y2, one)
    v = fe_add_bm(fe_mul_bm(y2, _const_bm(FE_D, dev)), one)
    v3 = fe_mul_bm(fe_sq_bm(v), v)
    uv7 = fe_mul_bm(fe_mul_bm(fe_sq_bm(v3), v), u)
    x = fe_mul_bm(fe_mul_bm(fe_pow_const_bm(uv7, _POW_EXP_BITS), v3), u)
    vx2 = fe_mul_bm(fe_sq_bm(x), v)
    root_ok = fe_eq_bm(vx2, u)
    neg_ok = fe_is_zero_bm(fe_add_bm(vx2, u))
    x = torch.where(
        (~root_ok & neg_ok)[None], fe_mul_bm(x, _const_bm(FE_SQRT_M1, dev)), x
    )
    valid = root_ok | neg_ok
    x_is_zero = fe_is_zero_bm(x)
    valid &= ~(x_is_zero & (sign > 0))
    flip = fe_parity_bm(x) != sign
    x = torch.where(flip[None], fe_sub_bm(torch.zeros_like(x), x), x)
    return Point(x, y_limbs, one, fe_mul_bm(x, y_limbs)), valid


def _stack(points) -> Point:
    return _point_map(lambda *xs: torch.stack(xs, dim=0), *points)


def _msb_first(bits: torch.Tensor) -> torch.Tensor:
    """[B, n] little-endian digits -> [n, B], most significant first."""
    return bits.flip(-1).T


def straus_double_scalarmult_bm(
    s_bits: torch.Tensor, k_bits: torch.Tensor, neg_a: Point
) -> Point:
    """R' = [s]B + [k](-A), one complete double + one table add per bit
    (MSB first) against the joint table {identity, B, -A, B-A}."""
    bsz, dev = s_bits.shape[0], s_bits.device
    one = torch.zeros((LIMBS, bsz), dtype=torch.int32, device=dev)
    one[0] = 1
    base = Point(*(
        _const_bm(c, dev).expand(LIMBS, bsz) for c in (FE_BX, FE_BY)
    ), one, _const_bm(FE_BT, dev).expand(LIMBS, bsz))
    tstack = _stack([pt_identity_bm(bsz, dev), base, neg_a,
                     pt_add_bm(base, neg_a)])
    q = pt_identity_bm(bsz, dev)
    for sb, kb in zip(_msb_first(s_bits), _msb_first(k_bits)):
        q = pt_add_bm(q, q)
        q = pt_add_bm(q, pt_select_stacked_bm(tstack, sb + 2 * kb))
    return q


# ---------------------------------------------------------------------------
# windowed joint-table ladder: w bits per step instead of 1
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _base_window_points(w: int) -> Tuple[Tuple[int, int, int], ...]:
    """Affine [i]B for i in [0, 2^w) as (x, y, x*y) integers mod p, from
    the oracle's exact big-int arithmetic (the identity is (0, 1, 0))."""
    from ..crypto import ed25519_ref as _ref

    points = []
    for i in range(1 << w):
        gx, gy, gz, _ = _ref.point_mul(i, _ref.BASE)
        zinv = pow(gz, _P_INT - 2, _P_INT)
        ax, ay = gx * zinv % _P_INT, gy * zinv % _P_INT
        points.append((ax, ay, ax * ay % _P_INT))
    return tuple(points)


@functools.lru_cache(maxsize=None)
def _base_window_consts(w: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host comb for the fixed base: affine [i]B for i in [0, 2^w) as
    (x, y, t) limb arrays of shape [2^w, LIMBS] (z = 1 everywhere)."""
    pts = _base_window_points(w)
    return tuple(np.stack([_int_to_limbs(p[c]) for p in pts]) for c in range(3))


def _scalar_windows(bits: torch.Tensor, w: int) -> torch.Tensor:
    """[..., 256] little-endian bits -> [..., ceil(256/w)] w-bit window
    values (little-endian window order; zero-padded above bit 255 when
    w does not divide 256)."""
    nbits = bits.shape[-1]
    nw = -(-nbits // w)
    pad = nw * w - nbits
    if pad:
        bits = torch.cat(
            [bits, torch.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype,
                               device=bits.device)], dim=-1)
    weights = torch.tensor([1 << i for i in range(w)], dtype=torch.int32,
                           device=bits.device)
    return (bits.reshape(bits.shape[:-1] + (nw, w)).to(torch.int32)
            * weights).sum(-1, dtype=torch.int32)


def _joint_table_bm(neg_a: Point, window: int) -> Point:
    """Joint table stacked [4^w, LIMBS, B] with T[j*2^w + i] = [i]B +
    [j](-A): the [j](-A) chain of 2^w - 2 complete adds, then ONE complete
    add over the whole (j, i) grid flattened into the batch axis."""
    n = 1 << window
    bsz, dev = neg_a.x.shape[1], neg_a.x.device
    chain = [pt_identity_bm(bsz, dev), neg_a]
    for _ in range(n - 2):
        chain.append(pt_add_bm(chain[-1], neg_a))
    a_flat = _point_map(
        lambda v: v[:, None].expand(n, n, LIMBS, bsz).permute(2, 0, 1, 3)
        .reshape(LIMBS, n * n * bsz), _stack(chain))
    bx, by, bt = _base_window_consts(window)
    ones = np.zeros((n, LIMBS), np.int32)
    ones[:, 0] = 1
    b_flat = Point(*[
        torch.from_numpy(arr.T.copy()).to(dev)[:, None, :, None]
        .expand(LIMBS, n, n, bsz).reshape(LIMBS, n * n * bsz)
        for arr in (bx, by, ones, bt)
    ])
    grid = pt_add_bm(a_flat, b_flat)
    return _point_map(
        lambda v: v.reshape(LIMBS, n * n, bsz).permute(1, 0, 2), grid)


def windowed_double_scalarmult_bm(
    s_bits: torch.Tensor, k_bits: torch.Tensor, neg_a: Point, window: int = 4
) -> Point:
    """R' = [s]B + [k](-A) via the w-bit joint table: ceil(256/w) steps of
    w dedicated doublings + 1 table-select-add (MSB-first windows)."""
    w = window
    table = _joint_table_bm(neg_a, w)
    q = pt_identity_bm(s_bits.shape[0], s_bits.device)
    for swi, kwi in zip(_msb_first(_scalar_windows(s_bits, w)),
                        _msb_first(_scalar_windows(k_bits, w))):
        for _ in range(w):
            q = pt_dbl_bm(q)
        q = pt_add_bm(q, pt_select_stacked_bm(table, swi + (kwi << w)))
    return q


# ---------------------------------------------------------------------------
# the batch verifiers
# ---------------------------------------------------------------------------


def _decompress_both(a_y, a_sign, r_y, r_sign):
    """A and R share ONE [22, 2B] decompression (one power ladder)."""
    bsz = a_y.shape[0]
    ys = torch.cat([a_y.T, r_y.T], dim=1)           # [22, 2B]
    signs = torch.cat([a_sign, r_sign], dim=0)      # [2B]
    pt, valid = pt_decompress_bm(ys, signs)
    a_pt = _point_map(lambda v: v[:, :bsz], pt)
    r_pt = _point_map(lambda v: v[:, bsz:], pt)
    return a_pt, valid[:bsz], r_pt, valid[bsz:]


def _verify_kernel_bm(
    a_y: torch.Tensor,      # i32[B, LIMBS] pubkey y limbs
    a_sign: torch.Tensor,   # i32[B] pubkey x sign bit
    r_y: torch.Tensor,      # i32[B, LIMBS] signature R y limbs
    r_sign: torch.Tensor,   # i32[B]
    s_bits: torch.Tensor,   # i32[B, 256] little-endian bits of S
    k_bits: torch.Tensor,   # i32[B, 256] little-endian bits of k
) -> torch.Tensor:
    """Verify through the Straus ladder -> bool[B] (device part only)."""
    a_pt, a_ok, r_pt, r_ok = _decompress_both(a_y, a_sign, r_y, r_sign)
    r_prime = straus_double_scalarmult_bm(s_bits, k_bits, pt_neg_bm(a_pt))
    return a_ok & r_ok & pt_eq_bm(r_prime, r_pt)


def _verify_kernel_windowed_bm(
    a_y: torch.Tensor,
    a_sign: torch.Tensor,
    r_y: torch.Tensor,
    r_sign: torch.Tensor,
    s_bits: torch.Tensor,
    k_bits: torch.Tensor,
    window: int = 4,
) -> torch.Tensor:
    """Verify through the windowed ladder; same verdicts as
    :func:`_verify_kernel_bm`."""
    a_pt, a_ok, r_pt, r_ok = _decompress_both(a_y, a_sign, r_y, r_sign)
    r_prime = windowed_double_scalarmult_bm(
        s_bits, k_bits, pt_neg_bm(a_pt), window
    )
    return a_ok & r_ok & pt_eq_bm(r_prime, r_pt)


def verify_rows(rows: torch.Tensor, ladder: str = "windowed",
                window: int = 2) -> torch.Tensor:
    """Plain version of kernel E1: device rows uint8[B, 128] (A | R | S | k,
    32 little-endian bytes each) -> bool[B] on the rows' device, the device
    part of the verdict (the host's S < L and y < p checks not included)."""
    host = rows.cpu().numpy()
    a_y, a_sign = _enc_to_limbs_and_sign(host[:, 0:32])
    r_y, r_sign = _enc_to_limbs_and_sign(host[:, 32:64])
    args = [torch.from_numpy(a).to(rows.device) for a in (
        a_y, a_sign, r_y, r_sign, _bytes_to_bits256(host[:, 64:96]),
        _bytes_to_bits256(host[:, 96:128]))]
    if ladder == "straus":
        return _verify_kernel_bm(*args)
    return _verify_kernel_windowed_bm(*args, window=window)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


def _bytes_to_bits256(rows: np.ndarray) -> np.ndarray:
    """[B,32] uint8 -> [B,256] int32, little-endian bit order."""
    return np.unpackbits(rows, axis=-1, bitorder="little").astype(np.int32)


def _enc_to_limbs_and_sign(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[B,32] uint8 point encodings -> (y limbs [B,22], sign [B])."""
    bits = np.unpackbits(rows, axis=-1, bitorder="little")  # [B,256]
    sign = bits[:, 255].astype(np.int32)
    y_bits = bits[:, :255].astype(np.int64)
    weights = 1 << np.arange(BITS, dtype=np.int64)
    limbs = np.zeros((rows.shape[0], LIMBS), np.int64)
    for l in range(LIMBS):
        seg = y_bits[:, l * BITS : min((l + 1) * BITS, 255)]
        limbs[:, l] = seg @ weights[: seg.shape[1]]
    return limbs.astype(np.int32), sign


def default_batch_major() -> bool:
    """The layout default: batch-major on every device (the port has only
    the batch-major form; ``batch_major=False`` runs it too)."""
    return True


def default_ladder() -> str:
    """The ladder default: the windowed joint-table ladder everywhere."""
    return "windowed"


def default_window(device="cuda") -> int:
    """Window size for ``ladder="windowed"`` on ``device``: 2 on the CPU,
    where the plain version's 4^w joint grid is real work (as in the JAX
    package); on a CUDA card 5, its fewest field multiplies and the
    fastest of kernel E1's six windows at the 128-signature window: the
    team at w = 1 ... 6 took 1.100 / 0.768 / 0.654 / 0.605 / 0.604 /
    0.633 ms there (``chip_smoke.py`` phase ``ed25519``, NVIDIA H100 80GB
    HBM3, 700 W; PERF.md section 6).  w = 4 is 2.0% faster for the team
    at 8,192 signatures (0.904 against 0.922 ms); the one-thread arm that
    serves 32,768 is fastest at 5 (3.094 against 3.196 ms at w = 4)."""
    return 2 if torch.device(device).type == "cpu" else 5


def prepare_rows(
    pks: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    pad_to: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The host part of a verify: (device rows uint8[b, 128], host_ok
    bool[n]).  Row i holds A, R, S and k = SHA512(R || A || M) mod L;
    ``host_ok`` is S < L, y_A < p and y_R < p.  Rows n..b-1 are zero
    padding (``pad_to``, default the next power of two)."""
    with span("validate.prepare_rows"):
        n = len(pks)
        pk_rows = np.frombuffer(b"".join(pks), np.uint8).reshape(n, 32)
        sig_rows = np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64)
        r_rows, s_rows = sig_rows[:, :32], sig_rows[:, 32:]

        # Host-side canonicity: S < L, y_A < p, y_R < p (cheap big-int checks).
        host_ok = np.ones(n, bool)
        for i in range(n):
            s_int = int.from_bytes(s_rows[i].tobytes(), "little")
            y_a = (int.from_bytes(pk_rows[i].tobytes(), "little")
                   & ((1 << 255) - 1))
            y_r = (int.from_bytes(r_rows[i].tobytes(), "little")
                   & ((1 << 255) - 1))
            host_ok[i] = (s_int < _L_INT) and (y_a < _P_INT) and (y_r < _P_INT)

        # k = SHA512(R || A || M) mod L, host-hashed.
        k_rows = np.zeros((n, 32), np.uint8)
        for i in range(n):
            d = hashlib.sha512(
                r_rows[i].tobytes() + pk_rows[i].tobytes() + msgs[i]
            ).digest()
            k = int.from_bytes(d, "little") % _L_INT
            k_rows[i] = np.frombuffer(k.to_bytes(32, "little"), np.uint8)

        b = pad_to or max(1, 1 << (n - 1).bit_length())
        if b < n:
            raise ValueError(f"pad_to ({b}) smaller than batch ({n})")
        rows = np.zeros((b, ROW_BYTES), np.uint8)
        rows[:n] = np.concatenate([pk_rows, r_rows, s_rows, k_rows], axis=1)
        return rows, host_ok


def verify_batch(
    pks: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    pad_to: int | None = None,
    batch_major: bool | None = None,
    ladder: str | None = None,
    window: int | None = None,
    device="cuda",
) -> np.ndarray:
    """Device-batched verify of n (pk, msg, sig) triples -> bool[n].

    Hashing and the canonicity pre-checks (S < L, y < p) run on the host
    (:func:`prepare_rows`); decompression, the ladder and the projective
    compare run on ``device``: kernel E1 on a CUDA device (it launches or
    raises), the plain version on the CPU.  ``pad_to`` rounds the batch up
    with zero rows.  ``ladder`` is ``"straus"`` (1-bit joint table) or
    ``"windowed"`` (``window`` bits per step, None -> :func:`default_window`);
    ``None`` takes :func:`default_ladder`.  ``batch_major`` is accepted for
    the JAX package's signature; both values run the same batch-major
    code.  All variants are verdict-identical.
    """
    from . import cuda_ed25519

    n = len(pks)
    if not (n == len(msgs) == len(sigs)):
        raise ValueError("pks/msgs/sigs length mismatch")
    if n == 0:
        return np.zeros(0, bool)
    rows, host_ok = prepare_rows(pks, msgs, sigs, pad_to)
    if ladder is None:
        ladder = default_ladder()
    if ladder not in ("straus", "windowed"):
        raise ValueError(f"unknown ladder {ladder!r}")
    if window is not None and ladder != "windowed":
        raise ValueError("window only applies to ladder='windowed'")
    w = 1
    if ladder == "windowed":
        w = default_window(device) if window is None else window
        if not 1 <= w <= 6:
            raise ValueError(f"window {w} outside the practical range [1, 6]")
    ok = cuda_ed25519.verify(torch.from_numpy(rows).to(device), ladder, w)
    return ok.cpu().numpy()[:n] & host_ok
