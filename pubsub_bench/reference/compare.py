"""The program's outputs held against the reference's.

The program keeps possession planes as packed 32-bit words and peer ids
in narrow storage; both are read back here as the plain values the
reference holds (a bit per message, -1 for an empty slot) before any
comparison.  Integer and boolean values must be equal.  Floats are
judged by their gap: the largest difference over an array, as a share of
the reference array's largest finite magnitude; an infinity or a NaN
must sit where the reference has the same one.  The flight record's
score quantiles are approximate by definition (128 bins over the
observed range), so they are judged in bins: the program's value may lie
one bin from the reference's.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

MASK = 0xFFFFFFFF
WORD_PLANES = {"have_w": "have", "fresh_w": "fresh",
               "gossip_pend_w": "gossip_pend", "iwant_pend_w": "iwant_pend",
               "fresh_hist": "fresh_hist"}
SCORE_QUANTILES = ("record.score_p10", "record.score_p50",
                   "record.score_p90")


def leaves(x, pre: str = "") -> Iterator[Tuple[str, object]]:
    """(name, leaf) of a (nested) NamedTuple state, nested names dropped
    to their last part (``counters.time_in_mesh`` -> ``time_in_mesh``)."""
    for name in type(x)._fields:
        v = getattr(x, name)
        if hasattr(v, "_fields"):
            yield from leaves(v, pre)
        else:
            yield pre + name, v


def to_host(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        if str(v.dtype) in ("torch.bfloat16", "torch.uint16"):
            v = v.float() if v.is_floating_point() else v.int()
        return v.numpy()
    return np.asarray(v)


def unpack_words(words: np.ndarray, m: int) -> np.ndarray:
    """Packed words [..., W] -> bool [..., m]: message i is bit i % 32 of
    word i // 32."""
    w = words.astype(np.int64) & MASK
    bits = (w[..., :, None] >> np.arange(32)) & 1
    return bits.reshape(w.shape[:-1] + (w.shape[-1] * 32,))[..., :m] > 0


def program_state(st, m: int, pre: str = "state.") -> Dict[str, np.ndarray]:
    """The program's state as the reference's plain arrays, by name."""
    out = {}
    for name, v in leaves(st):
        a = to_host(v)
        if name in WORD_PLANES:
            out[pre + WORD_PLANES[name]] = unpack_words(a, m)
        elif name in ("nbrs", "rev"):
            if a.dtype == np.uint16 or str(getattr(v, "dtype", "")) == \
                    "torch.uint16":
                a = np.where(a.astype(np.int64) == 0xFFFF, -1, a)
            out[pre + name] = a.astype(np.int64)
        elif name == "key":
            out[pre + name] = a.astype(np.int64) & MASK
        else:
            out[pre + name] = a
    return out


def reference_state(st: dict, m: int, pre: str = "state."
                    ) -> Dict[str, np.ndarray]:
    out = {pre + k: to_host(v) for k, v in st.items()}
    n = st["have"].shape[0]
    out[pre + "fresh_hist"] = np.zeros((n, 0, m), bool)
    return out


def named(d: dict, pre: str) -> Dict[str, np.ndarray]:
    return {pre + k: to_host(v) for k, v in d.items()}


def _is_float(a: np.ndarray) -> bool:
    return a.dtype.kind == "f"


def judge(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
          widths: np.ndarray = None) -> Dict[str, object]:
    """``mismatches`` (elements that differ, by name), ``float_gap`` (the
    largest float gap) and ``quantile_bins`` (the largest distance of a
    score quantile, in bins of ``widths`` [rounds])."""
    mism, gap, bins = {}, 0.0, 0.0
    for name, ref in want.items():
        ref = np.asarray(ref)
        if name not in got:
            mism[name] = max(ref.size, 1)
            continue
        prog = np.asarray(got[name])
        if prog.shape != ref.shape:
            mism[name] = max(ref.size, prog.size, 1)
            continue
        if not (_is_float(ref) or _is_float(prog)):
            bad = int(np.count_nonzero(prog.astype(np.int64)
                                       != ref.astype(np.int64)))
            if bad:
                mism[name] = bad
            continue
        p, r = prog.astype(np.float64), ref.astype(np.float64)
        fin = np.isfinite(r) & np.isfinite(p)
        odd = ~fin & ~((p == r) | (np.isnan(p) & np.isnan(r)))
        if np.count_nonzero(odd):
            mism[name] = int(np.count_nonzero(odd))
        if not fin.any():
            continue
        diff = np.abs(p[fin] - r[fin])
        if name in SCORE_QUANTILES and widths is not None:
            w = np.broadcast_to(widths, r.shape)[fin]
            steps = np.where(w > 0, diff / np.where(w > 0, w, 1.0),
                             np.where(diff > 0, np.inf, 0.0))
            bins = max(bins, float(steps.max()))
            continue
        scale = float(np.abs(r[fin]).max())
        gap = max(gap, float(diff.max()) / scale if scale > 0 else
                  (np.inf if diff.max() > 0 else 0.0))
    return {"mismatches": mism, "float_gap": gap, "quantile_bins": bins}


def bit_holders(have: np.ndarray, slot: int) -> np.ndarray:
    """Peers holding window slot ``slot`` in a plain possession plane."""
    return np.asarray(have)[:, int(slot)]
