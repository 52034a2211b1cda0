"""GF(256) field arithmetic: the coded (RLNC) plane's byte matrices.

Port of the JAX package's ``ops/gf256.py``.  A message is a generation of
K source fragments; relays forward random GF(256) combinations of what
they hold (``gf_combine``/``gf_matmul``) and a receiver decodes from any K
independent combinations (``rref_insert``/``gf_solve``).

The field is GF(2^8) with the AES polynomial ``x^8 + x^4 + x^3 + x + 1``
(0x11B) and generator 0x03, as in the reference: addition is XOR, and
the log/antilog tables (``GF_EXP``/``GF_LOG``, the antilog doubled to 510
entries) are the reference's.  On the device a product is one lookup in
the 256 x 256 table those tables fill (``GF_MUL``, zero rows and columns
included), which is the reference's ``exp[log a + log b]`` with its zero
mask, value for value; ``gf_inv`` is a lookup in ``GF_INV``
(``exp[255 - log a]``, 0 -> 0).  Each table is copied to a device once
and cached there.

``gf_matmul_mxu``/``gf_combine_mxu`` keep the reference's carry-less
decomposition: each operand splits into 8 bit planes, one float32 matmul
counts the bit-pair overlaps over the contraction axis (a count is at
most the contraction length, at most 255, so float32 holds it exactly),
and the parity of each of the 15 polynomial coefficient planes folds back
to a byte through the residues ``x^t mod 0x11B``.  Bit-exact with the
table form; an optional arm (``RLNC(use_mxu=True)``), off by default.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import rng

_POLY = 0x11B  # AES reduction polynomial
_GEN = 0x03    # multiplicative generator


def _build_tables() -> Tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # x *= 0x03  ==  xtime(x) ^ x, reduced mod _POLY.
        x2 = (x << 1) ^ (_POLY if x & 0x80 else 0)
        x = x2 ^ x
    exp[255:510] = exp[0:255]  # doubled: exp[log a + log b] needs no mod
    return exp, log


GF_EXP, GF_LOG = _build_tables()
_A = np.arange(256)
# GF_MUL[a, b] = exp[log a + log b], 0 where a or b is 0 (flattened).
GF_MUL = np.where(
    (_A[:, None] == 0) | (_A[None, :] == 0), 0,
    GF_EXP[GF_LOG[_A][:, None] + GF_LOG[_A][None, :]],
).astype(np.uint8).reshape(-1)
GF_INV = np.where(_A == 0, 0, GF_EXP[255 - GF_LOG[_A]]).astype(np.uint8)

_TABLES: Dict[Tuple[str, str], torch.Tensor] = {}


def _table(name: str, device: torch.device) -> torch.Tensor:
    key = (name, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.from_numpy(
            {"mul": GF_MUL, "inv": GF_INV}[name]).to(device)
    return t


def gf_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(256) product of uint8 tensors (broadcasting)."""
    idx = (a.to(torch.int32) << 8) | b       # b promotes to int32
    return _table("mul", idx.device)[idx]


def gf_inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise multiplicative inverse; maps 0 -> 0 (callers mask the
    zero case, as ``rref_insert``/``gf_solve`` do)."""
    return _table("inv", a.device)[a.to(torch.int32)]


def gf_combine(coeffs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``XOR_k coeffs[..., k] * rows[..., k, :]``: u8[..., K] and
    u8[..., K, L] -> u8[..., L] (broadcasting over the leading axes).  The
    encode: one coded fragment is a coefficient row combined over a
    holder's basis rows, one [..., L] product per term."""
    k = rows.shape[-2]
    acc = gf_mul(coeffs[..., 0:1], rows[..., 0, :])
    for i in range(1, k):
        acc = acc ^ gf_mul(coeffs[..., i:i + 1], rows[..., i, :])
    return acc


def gf_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched GF(256) matrix product: u8[..., M, K] x u8[..., K, N] ->
    u8[..., M, N] (products XOR-accumulated over the contraction axis)."""
    prod = gf_mul(a[..., :, :, None], b[..., None, :, :])   # [..., M, K, N]
    acc = prod[..., 0, :]
    for i in range(1, prod.shape[-2]):
        acc = acc ^ prod[..., i, :]
    return acc


# Residues x^t mod 0x11B for t = 8..14: where the high coefficient planes of
# the 15-term carry-less product land after polynomial reduction.
_MXU_REDUCE = (0x1B, 0x36, 0x6C, 0xD8, 0xAB, 0x4D, 0x9A)


def _planes(x: torch.Tensor) -> torch.Tensor:
    """u8[..., R, C] -> float32 0/1 bit planes [..., 8, R, C]."""
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    return ((x.to(torch.int32)[..., None, :, :] >> shifts[:, None, None])
            & 1).to(torch.float32)


def gf_matmul_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`gf_matmul` through bit-plane matmuls: u8[..., M, K] x
    u8[..., K, N] -> u8[..., M, N], bit-exact with the table form.

    Coefficient t of the XOR-accumulated carry-less product is the parity
    of ``sum_k sum_{i+j=t} a_i[m, k] * b_j[k, n]`` over the bit planes
    ``a_i = (a >> i) & 1``; one float32 matmul gives all 64 plane-pair
    counts, each an exact integer (at most K <= 255)."""
    ap, bp = _planes(a), _planes(b)                 # [..., 8, M, K], [..., 8, K, N]
    counts = torch.einsum("...imk,...jkn->...ijmn", ap, bp)
    counts = counts.to(torch.int32)                 # [..., 8, 8, M, N]
    acc = None
    for t in range(15):
        tot = None
        for i in range(max(0, t - 7), min(7, t) + 1):
            c = counts[..., i, t - i, :, :]
            tot = c if tot is None else tot + c
        w = (1 << t) if t < 8 else _MXU_REDUCE[t - 8]
        term = ((tot & 1) * w).to(torch.uint8)      # coefficient plane t
        acc = term if acc is None else acc ^ term
    return acc


def gf_combine_mxu(coeffs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """:func:`gf_combine` through :func:`gf_matmul_mxu`: the encode as a
    [1, K] x [K, L] byte product (same broadcasting contract)."""
    return gf_matmul_mxu(coeffs[..., None, :], rows)[..., 0, :]


def coeffs_by_uid(
    key: torch.Tensor,
    shape: Sequence[int],
    uid: Optional[torch.Tensor] = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Random u8 coefficients, ``jax.random.randint(key, shape, 0, 256)``
    cast to uint8; row axis 0 is the peer.  ``row_offset`` draws rows
    ``[row_offset, row_offset + shape[0])`` of a larger draw alone.  Under
    a placement relabeling ``uid`` (int[N], physical row -> canonical id)
    keys each row on canonical identity: physical rows ``[row_offset,
    row_offset + shape[0])`` draw the canonical rows ``uid`` names there,
    alone (``rng.randint(rows=)``), bit for bit the reference's whole draw
    gathered at ``uid``."""
    if uid is None:
        return rng.randint(key, shape, 0, 256,
                           row_offset=row_offset).to(torch.uint8)
    rows = uid[row_offset:row_offset + shape[0]]
    return rng.randint(key, shape, 0, 256, rows=rows).to(torch.uint8)


# ---------------------------------------------------------------------------
# structured Gaussian elimination: the streaming decode-rank fold
# ---------------------------------------------------------------------------


def rref_insert(basis: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one received coefficient vector into structured bases, batched
    over the leading axes: ``basis`` u8[..., K, K], ``v`` u8[..., K] ->
    ``(basis', inserted bool[...])``.

    Pivot-slot form, as the reference's: row p is all-zero (absent) or has
    its first nonzero at column p, normalised to 1.  ``v`` is eliminated
    against every present row in pivot order (the reference's
    ``fori_loop``, a Python loop over the K pivots here); the residual's
    first nonzero column is an empty slot, where the residual is stored
    scaled by the inverse of that entry.  A dependent (or zero) vector
    leaves the basis unchanged."""
    kk = basis.shape[-1]
    v = v.to(torch.uint8)
    mul = _table("mul", basis.device)
    # 256 where pivot p is present, else 0: v[p] * shift[p] is the product
    # table's row of the factor (row 0, all zeros, for an absent pivot).
    shift = (torch.diagonal(basis, dim1=-2, dim2=-1) != 0).to(
        torch.int32) << 8
    for p in range(kk):
        idx = (v[..., p] * shift[..., p])[..., None] | basis[..., p, :]
        v = v ^ mul[idx]
    nz = v != 0
    inserted = nz.any(dim=-1)
    p = torch.argmax(nz.to(torch.uint8), dim=-1, keepdim=True)  # first nonzero
    newrow = gf_mul(gf_inv(torch.gather(v, -1, p)), v)
    cols = torch.arange(kk, device=basis.device)
    put = (cols == p) & inserted[..., None]                      # [..., K]
    basis = torch.where(put[..., None], newrow[..., None, :], basis)
    return basis, inserted


def gf_rank(basis: torch.Tensor) -> torch.Tensor:
    """int32[...]: occupied pivot slots of structured bases u8[..., K, K]
    (as :func:`rref_insert` keeps them)."""
    diag = torch.diagonal(basis, dim1=-2, dim2=-1)
    return (diag != 0).sum(dim=-1, dtype=torch.int32)


def gf_solve(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve ``A @ X = B`` over GF(256) by Gauss-Jordan with row pivoting:
    ``a`` u8[K, K], ``b`` u8[K, L] -> ``(x u8[K, L], ok)``, ``ok`` a bool
    0-d tensor, False when A is singular (x is then garbage, the
    reference's garbage).  The reference's column loop, on the device."""
    kk = a.shape[0]
    dev = a.device
    ab = torch.cat([a.to(torch.uint8), b.to(torch.uint8)], dim=1)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    rows = torch.arange(kk, device=dev)
    for i in range(kk):
        cand = (rows >= i) & (ab[:, i] != 0)
        ok = ok & cand.any()
        piv = torch.argmax(cand.to(torch.uint8))
        ri, rp = ab[i].clone(), ab[piv].clone()
        ab = ab.clone()
        ab[i] = rp
        ab.index_copy_(0, piv[None], ri[None])
        row = gf_mul(gf_inv(ab[i, i])[None], ab[i])
        factors = torch.where(rows == i, 0, ab[:, i]).to(torch.uint8)
        ab = ab ^ gf_mul(factors[:, None], row[None, :])
        ab[i] = row
    return ab[:, kk:], ok
