"""Kernel E1, batched ed25519 verification on the card, and its wrapper.

Source: ``csrc/ed25519_verify.cu``, built with ``nvcc`` for ``sm_90a`` into
the package's ``build/`` directory on first use and loaded with ctypes (a
plain C interface: pointers from ``data_ptr()``, PyTorch's current stream,
``cudaGetLastError()`` returned and checked).

:func:`verify` replaces the JAX package's
``ops/ed25519.py:_verify_kernel_windowed_bm`` and ``_verify_kernel_bm`` (an
XLA program there, not a Pallas kernel).  Bound on the card: integer
multiplies -- 128 bytes in and 1 out per signature against ~3.7k field
multiplies (:func:`fe_mul_count`).  What holds it back is latency: a
signature is a chain of dependent multiplies, and the main path's batch
of 128 fills few SMs.  So a team of four lanes verifies each signature
(:data:`LANES`), eight to a warp: every point operation is two rounds of
one field multiply a lane, ~1,095 multiplies on the critical path instead
of 3,685 at w = 5; the source says how.  From :data:`ONE_THREAD_FROM`
signatures up, where the card is full and the team's ~19% more
lane-multiplies cost more than its shorter chain saves, one thread
verifies each signature instead.  The bound stays the work:
``fe_mul_count(w)`` multiplies a signature.  Its plain version is
``ops/ed25519.py:verify_rows`` (the twin of the JAX functions, limb for
limb).  The wrapper runs the plain version only when its rows lie on the
CPU; on a CUDA tensor it launches E1 or raises.  It counts its launches in
``verify.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional

import numpy as np
import torch

from . import cuda_build
from . import ed25519 as plain
from .cuda_build import device_index as _index
from .cuda_build import raise_on as _raise_on

SOURCE = os.path.join(cuda_build.CSRC_DIR, "ed25519_verify.cu")
LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libed25519_verify.so")
WINDOWS = (1, 2, 3, 4, 5, 6)  # the kernel's instantiations
LANES = 4  # lanes a signature (E1_LANES in the source)
# Threads a block, both arms (E1_THREADS in the source).  The team's block
# sweep at 32 / 64 / 128 / 256 threads, w = 5: 0.611 / 0.607 / 0.608 /
# 0.907 ms at B = 128, 3.883 / 3.824 / 3.750 / 3.728 ms at B = 32,768,
# where the one-thread arm serves (tools/e1_sweep.py; NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 6).
THREADS = 128
# From this many signatures up, one thread a signature: the team does ~19%
# more lane-multiplies a signature, and once the batch fills the card that
# costs more than its shorter chain saves.  Verifier users send such
# batches: the reference's device curve reaches 32,768 (bench.py's
# ``device_curve``), through ``ed25519.verify_batch(pad_to=...)``.  The arm
# sweep at w = 5, team / one thread, mean of two turns: 3.116 / 3.137 ms
# at 25,600 and 3.191 / 3.159 ms at 26,624 (tools/e1_sweep.py; NVIDIA H100
# 80GB HBM3, 700 W; PERF.md section 6).
ONE_THREAD_FROM = 26624
_MASK51 = (1 << 51) - 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tables = {}


def build(verbose: bool = False) -> str:
    """Compile ``csrc/ed25519_verify.cu`` into ``build/`` (always) and
    return nvcc's output (``-Xptxas -v`` register/stack/spill report when
    ``verbose``)."""
    return cuda_build.build(SOURCE, LIB_PATH, verbose)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if cuda_build.stale(SOURCE, LIB_PATH):
            build()
        lib = ctypes.CDLL(LIB_PATH)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ed25519_verify.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.ed25519_verify.restype = ci
        lib.ed25519_fe_mul_probe.argtypes = [vp, vp, vp, ci, vp]
        lib.ed25519_fe_mul_probe.restype = ci
        _lib = lib
        return lib


def to_limbs51(v: int) -> list:
    """An integer mod p as five radix-2^51 limbs (the kernel's field
    element)."""
    v %= plain._P_INT
    return [(v >> (51 * i)) & _MASK51 for i in range(5)]


@functools.lru_cache(maxsize=None)
def base_table_host(w: int) -> np.ndarray:
    """[i]B for i in [0, 2^w) in the kernel's niels form (y+x, y-x, 2dxy)
    as uint64[2^w, 3, 5] radix-2^51 limbs, from the same oracle comb as
    the plain version's ``_base_window_consts``."""
    p, d2 = plain._P_INT, 2 * plain._D_INT
    rows = [[to_limbs51(y + x), to_limbs51(y - x + p), to_limbs51(d2 * t)]
            for x, y, t in plain._base_window_points(w)]
    return np.array(rows, np.uint64)


def _base_table(w: int, dev: torch.device) -> torch.Tensor:
    key = (w, str(dev))
    if key not in _tables:
        _tables[key] = torch.from_numpy(
            base_table_host(w).view(np.int64)).to(dev)
    return _tables[key]


def fe_mul_count(w: int) -> int:
    """Field multiplies (squarings included) one verification performs in
    E1 at window ``w``, counted from the kernel's code: two
    decompressions of 275 (7 + the 262 of ``fe_pow22523`` + 6), the
    cached -A (1), the chain of 2^w - 2 adds with their cached forms (9
    each), ceil(256/w) steps of w doublings (8 each) and two adds (7 + 8),
    and the projective compare (4).  No count depends on the data."""
    return 2 * 275 + 1 + 9 * ((1 << w) - 2) + (-(-256 // w)) * (8 * w + 15) + 4


def launch_lanes(n: int) -> int:
    """Lanes a signature of the arm :func:`verify` launches for a batch of
    ``n``: the team below :data:`ONE_THREAD_FROM`, one thread from it up."""
    return LANES if n < ONE_THREAD_FROM else 1


def sigs_per_block(n: int) -> int:
    """Signatures a block of the arm :func:`verify` launches for ``n``."""
    return THREADS // launch_lanes(n)


def verify(rows: torch.Tensor, ladder: str = "windowed",
           window: int = 4) -> torch.Tensor:
    """The device part of a batch verify (kernel E1; same contract as
    ``ed25519.verify_rows``): rows uint8[B, 128] (A | R | S | k) ->
    bool[B] on the rows' device.  ``ladder="straus"`` is the 1-bit
    window.  The arm follows the batch size (:func:`launch_lanes`)."""
    if rows.device.type == "cpu":
        return plain.verify_rows(rows, ladder, window)
    return _launch(rows, ladder, window, launch_lanes(rows.shape[0]))


def _verify_arm(rows: torch.Tensor, window: int, lanes: int) -> torch.Tensor:
    """One arm of E1 at any batch, on the card: ``lanes`` 4 (the team) or
    1 (one thread a signature).  For the tests and the sweeps that hold
    the two arms against each other."""
    if rows.device.type != "cuda" or lanes not in (1, LANES):
        raise ValueError(f"_verify_arm: {lanes} lanes on {rows.device}")
    return _launch(rows, "windowed", window, lanes)


def _launch(rows: torch.Tensor, ladder: str, window: int,
            lanes: int) -> torch.Tensor:
    if rows.device.type != "cuda":
        raise ValueError(f"verify: unsupported device {rows.device}")
    if ladder not in ("straus", "windowed"):
        raise ValueError(f"unknown ladder {ladder!r}")
    w = 1 if ladder == "straus" else int(window)
    if w not in WINDOWS:
        raise ValueError(f"window {w} outside the kernel's range {WINDOWS}")
    if rows.dtype != torch.uint8:
        raise TypeError(f"rows: dtype {rows.dtype}, expected torch.uint8")
    if rows.dim() != 2 or rows.shape[1] != plain.ROW_BYTES:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, expected "
                         f"(B, {plain.ROW_BYTES})")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows: must be contiguous and 16-byte aligned")
    n = rows.shape[0]
    if n == 0:
        raise ValueError("rows: empty batch")
    if n > 2**31 - 1:
        raise ValueError(f"rows: {n} rows exceed the kernel's int count")
    dev = rows.device
    lib = _load()
    table = _base_table(w, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(_index(dev)):
        code = lib.ed25519_verify(
            rows.data_ptr(), table.data_ptr(), out.data_ptr(), n, w, lanes,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "ed25519_verify launch")
    verify.launches += 1
    return out


verify.launches = 0


def fe_mul_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One E1 field multiply per row: int64[n, 5] radix-2^51 limbs (values
    below 2^51) on the card -> int64[n, 5], weakly reduced.  Checks the
    kernel's multiply against integers; not counted as an E1 launch."""
    if a.device.type != "cuda" or a.shape != b.shape or a.dim() != 2 \
            or a.shape[1] != 5 or a.dtype != torch.int64 \
            or b.dtype != torch.int64 or b.device != a.device:
        raise ValueError("fe_mul_probe: two int64[n, 5] tensors on one card")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    lib = _load()
    with torch.cuda.device(_index(a.device)):
        code = lib.ed25519_fe_mul_probe(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(code, "ed25519_fe_mul_probe launch")
    return out


def reset_launches() -> None:
    """Set E1's launch count to 0."""
    verify.launches = 0
