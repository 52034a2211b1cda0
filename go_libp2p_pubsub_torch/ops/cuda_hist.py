"""The flight recorder's latency-histogram kernel and its wrapper.

Source: ``csrc/latency_hist.cu``, built with ``nvcc`` for ``sm_90a`` into
the package's ``build/`` directory on first use and loaded with ctypes (a
plain C interface: pointers from ``data_ptr()``, PyTorch's current stream,
``cudaGetLastError()`` returned and checked).

It replaces no TPU kernel (the JAX package leaves the recount to XLA's
scatter-add).  :mod:`ops.histogram` launches it for the recorder's
recount on CUDA tensors: :func:`latency_hist` bins a whole
``first_step`` table of T topics in one pass, where the plain version
(``histogram.latency_histogram_topics`` on the CPU) is a clamp, a mask and
an ``index_add_`` of ones with every stamp an atomic on one of
``n_bins + 1`` addresses.  Bound on the card: device-memory bytes, one
read of the table (see the source).

The grid plan is plain Python (:func:`grid_blocks`), so the CPU tests
reach it; the card says how many blocks an SM holds
(:func:`blocks_per_sm`, the occupancy calculator).  ``latency_hist.
launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build
from .cuda_build import device_index as _index
from .cuda_build import raise_on as _raise_on
from .cuda_build import sm_count
from ..utils.trace import span

SOURCE = os.path.join(cuda_build.CSRC_DIR, "latency_hist.cu")
LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "liblatency_hist.so")
THREADS = 256       # a block's threads (csrc kThreads)
GROUP_ROWS = 32     # peer rows a warp takes at once (one ballot)
# latency_hist_host's and latency_hist_launch's arguments up to n_bins
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_occupancy: Dict[Tuple[int, int, int], int] = {}


def build(verbose: bool = False) -> str:
    """Compile ``csrc/latency_hist.cu`` into ``build/`` (always) and return
    nvcc's output (``-Xptxas -v`` register/spill report when
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
        ci = ctypes.c_int
        lib.latency_hist_launch.argtypes = ARGTYPES + [ci, ctypes.c_void_p]
        lib.latency_hist_launch.restype = ci
        lib.latency_hist_occupancy.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.latency_hist_occupancy.restype = ci
        _lib = lib
        return lib


def operands(first_step, msg_birth, msg_mask, peer_mask, n_bins: int
             ) -> Tuple[int, int, int]:
    """(T, N, M) of a launch, after checking what the kernel reads:
    ``first_step`` int32[T, N, M], ``msg_birth`` int32[T, M], ``msg_mask``
    bool[T, M], ``peer_mask`` bool[T, N], all contiguous on one device, and
    ``n_bins >= 1``."""
    if first_step.dim() != 3:
        raise ValueError(f"latency_hist: first_step is [T, N, M], got "
                         f"{tuple(first_step.shape)}")
    t, n, m = first_step.shape
    for name, x, dtype, shape in (
            ("first_step", first_step, torch.int32, (t, n, m)),
            ("msg_birth", msg_birth, torch.int32, (t, m)),
            ("msg_mask", msg_mask, torch.bool, (t, m)),
            ("peer_mask", peer_mask, torch.bool, (t, n))):
        if x.device != first_step.device:
            raise ValueError(f"latency_hist: {name} on {x.device}, expected "
                             f"{first_step.device}")
        if x.dtype != dtype:
            raise TypeError(f"latency_hist: {name} dtype {x.dtype}, "
                            f"expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"latency_hist: {name} shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"latency_hist: {name} must be contiguous")
    if n_bins < 1:
        raise ValueError(f"latency_hist: n_bins {n_bins} < 1")
    return t, n, m


def grid_blocks(t: int, n: int, blocks_per_sm: int, sm_count: int) -> int:
    """Blocks a topic (the grid's x; its y is ``t``): one per
    ``THREADS // 32`` groups of ``GROUP_ROWS`` rows, at most the blocks
    the ``sm_count`` SMs hold at once split over the topics (each block
    then loops over every ``grid``-th warp's groups)."""
    groups = -(-n // GROUP_ROWS)
    need = -(-groups // (THREADS // 32))
    return max(1, min(need, blocks_per_sm * sm_count // max(t, 1)))


def blocks_per_sm(dev: torch.device, n_bins: int, m: int) -> int:
    """Blocks of the kernel an SM of ``dev`` holds at once at ``n_bins``
    bins and ``m`` messages (its shared memory; cached)."""
    key = (_index(dev), n_bins, m)
    if key not in _occupancy:
        lib = _load()
        out = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            _raise_on(lib.latency_hist_occupancy(n_bins, m, ctypes.byref(out)),
                      "latency_hist_occupancy")
        if out.value < 1:
            raise ValueError(f"latency_hist: no block fits an SM at "
                             f"{n_bins} bins and {m} messages")
        _occupancy[key] = out.value
    return _occupancy[key]


def latency_hist(first_step: torch.Tensor, msg_birth: torch.Tensor,
                 msg_mask: torch.Tensor, peer_mask: torch.Tensor,
                 n_bins: int) -> torch.Tensor:
    """int32[n_bins]: the first-receipt latencies of every topic's stamp
    table, summed over the topics, in one launch on CUDA tensors (see
    :func:`operands`): a stamp counts where ``first_step >= 0`` under both
    masks, at bin ``clamp(first_step - msg_birth, 0, n_bins - 1)``."""
    with span("kernel.hist"):
        if first_step.device.type != "cuda":
            raise ValueError(f"latency_hist: unsupported device "
                             f"{first_step.device}")
        t, n, m = operands(first_step, msg_birth, msg_mask, peer_mask,
                           n_bins)
        dev = first_step.device
        out = torch.zeros(n_bins, dtype=torch.int32, device=dev)
        if t * n * m == 0:
            return out
        lib = _load()
        grid = grid_blocks(t, n, blocks_per_sm(dev, n_bins, m), sm_count(dev))
        code = lib.latency_hist_launch(
            first_step.data_ptr(), msg_birth.data_ptr(), msg_mask.data_ptr(),
            peer_mask.data_ptr(), out.data_ptr(), t, n, m, n_bins, grid,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(code, "latency_hist launch")
        latency_hist.launches += 1
        return out


latency_hist.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch count to 0."""
    latency_hist.launches = 0
