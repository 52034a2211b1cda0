"""The yardstick of the kernels: the work each must do, and the card's peaks.

K1 (``gossip_propagate``) and K2 (``gossip_exchange``) are bound by
device-memory bytes; their counts are copied from ``chip_smoke.py``
(``propagate_bytes``, ``exchange_bytes``): every input counted once, a
sender's words once per distinct row, every output written once.

E1 (``ed25519_verify``) is bound by 32-bit integer multiplies.  Its count
is frozen here from the algorithm as it stood when the benchmark was
written (w = 5): 3,685 field multiplies a verification, 125 IMADs a field
multiply (read from E1's SASS then).  A later change to E1's limbs or
window does not move this yardstick.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
IMAD_PER_CLK_SM = 64           # 32-bit IMAD issue rate, compute cap. 9.0
E1_FE_MULS_PER_VERIFY = 3685   # field multiplies a verification at w = 5
E1_IMADS_PER_FE_MUL = 125      # IMADs a field multiply
E1_BYTES_PER_ROW = 129         # 128 bytes in, 1 verdict byte out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def propagate_bytes(args, kw, out) -> int:
    """Bytes K1 must move for these inputs: every [N, K] mask and [N, W]
    plane read once, a neighbor id only where the edge delivers, the
    sender words once per distinct sender row, every output written once."""
    import torch

    mesh, nbrs, edge_live, alive, have, fresh, valid = args
    ok = mesh & edge_live
    n_ok = int(ok.sum())
    if "fresh_src" in kw:
        senders = _nbytes(kw["fresh_src"]) * n_ok // max(ok.numel(), 1)
        ids = 0
    else:
        rows = torch.unique(torch.clamp(nbrs[ok], 0, nbrs.shape[0] - 1))
        senders = int(rows.numel()) * fresh.shape[1] * 4
        ids = 4 * n_ok
    return (_nbytes(mesh, edge_live, alive, have, valid, kw.get("idw_have_w"))
            + ids + senders + _nbytes(*out))


def exchange_bytes(args, out) -> int:
    """Bytes K2 must move: the [N, K] masks, the dedup view and liveness
    read once, an advertiser id and its words only where it advertised
    (distinct rows once), every output written once."""
    import torch

    jidx_p, adv_ok_p, accept_p, serve_p, rows, dedup, alive = args
    n_adv = int(adv_ok_p.sum())
    distinct = torch.unique(jidx_p[adv_ok_p]).numel()
    return (_nbytes(adv_ok_p, accept_p, serve_p, dedup, alive) + 4 * n_adv
            + int(distinct) * rows.shape[1] * 4 + _nbytes(*out))


def bytes_least_s(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S


def e1_least_s(batch: int, sms: int, max_sm_clock_mhz: float) -> float:
    """The least time for ``batch`` verifications: the larger of the
    integer multiplies at 64 IMAD a clock on every SM at the card's
    maximum SM clock, and the bytes at the memory rate."""
    ops = E1_FE_MULS_PER_VERIFY * E1_IMADS_PER_FE_MUL * batch
    rate = IMAD_PER_CLK_SM * sms * max_sm_clock_mhz * 1e6
    return max(ops / rate, E1_BYTES_PER_ROW * batch / HBM_BYTES_PER_S)
