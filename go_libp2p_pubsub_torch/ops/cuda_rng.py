"""The PRNG's CUDA kernel (threefry-2x32) and its wrapper.

Source: ``csrc/threefry.cu``, built with ``nvcc`` for ``sm_90a`` into the
package's ``build/`` directory on first use and loaded with ctypes (a
plain C interface: pointers from ``data_ptr()``, PyTorch's current
stream, ``cudaGetLastError()`` returned and checked).

It replaces no TPU kernel (the JAX package leaves ``jax.random`` to XLA).
:mod:`ops.rng` launches it for every draw on a CUDA key: a key split, a
uniform draw, ``fold_in``, 32 random bits or ``randint`` is one launch,
where the PyTorch form of the hash is about 160 elementwise launches.
Bound on the card: integer operations (see the source).

A draw is described by a :class:`Plan`: how each element's 64-bit counter
is formed (:data:`RANGE`, :data:`ROWS`, :data:`DATA`), what is written
(:data:`PAIR`, :data:`BITS`, :data:`UNIFORM`, :data:`RANDINT`) and the
output's parameters.  The plans are plain Python, so the CPU tests reach
them; :func:`threefry` launches one.  ``threefry.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from .cuda_build import raise_on as _raise_on
from .cuda_build import sm_count
from ..utils.trace import span

SOURCE = os.path.join(cuda_build.CSRC_DIR, "threefry.cu")
LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libthreefry.so")
THREADS = 256       # a block's threads, one an element (csrc kThreads)
BLOCKS_PER_SM = 8   # grid cap: 2,048 threads an SM, the most it holds

_M32 = 0xFFFFFFFF
# Counter forms: element i hashes (hi, lo) of
RANGE = 0   # start + i
ROWS = 1    # idx[i // inner] * inner + i % inner
DATA = 2    # (0, idx[i] mod 2**32)
# Outputs
PAIR = 0      # int32[..., 2]: both words (a key)
BITS = 1      # int32: the words' xor
UNIFORM = 2   # float32 in [minval, maxval)
RANDINT = 3   # int32 in [minval, maxval), over split(key, 2)
_OUT_DTYPES = {PAIR: torch.int32, BITS: torch.int32, UNIFORM: torch.float32,
               RANDINT: torch.int32}


class Plan(NamedTuple):
    """One launch's arguments, but for the tensors."""

    form: int
    out: int
    start: int              # RANGE: the first element's counter
    n: int                  # elements
    inner: int              # ROWS: elements a row
    shape: Tuple[int, ...]  # the output's shape
    lo: float = 0.0         # UNIFORM: float32 minval ...
    width: float = 0.0      # ... and maxval - minval
    use_fma: int = 0        # UNIFORM: lo + f * width in one rounding
    span: int = 0           # RANDINT: maxval - minval as uint32 (1 if empty)
    mult: int = 0           # RANDINT: (2**16 % span)**2 % span, uint32
    minval: int = 0         # RANDINT: minval as uint32


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def counter_plan(out: int, shape: Sequence[int], row_offset: int = 0,
                 by_rows: bool = False, **params) -> Plan:
    """The plan of a draw of ``shape`` (the leading axis its rows): rows
    ``[row_offset, row_offset + shape[0])`` of a larger draw with the same
    trailing axes (:data:`RANGE`), or with ``by_rows`` the rows that a
    row-id tensor of ``shape[0]`` ids names (:data:`ROWS`).  ``params``:
    the output's (:func:`uniform_params`, :func:`randint_params`)."""
    shape = tuple(int(d) for d in shape)
    n = _numel(shape)
    if by_rows:
        return Plan(ROWS, out, 0, n, _numel(shape[1:]), _out_shape(out, shape),
                    **params)
    start = int(row_offset) * (n // shape[0]) if row_offset else 0
    return Plan(RANGE, out, start, n, 1, _out_shape(out, shape), **params)


def fold_plan(data) -> Plan:
    """``fold_in``'s plan: a scalar ``data`` is the one counter (0, data
    mod 2**32) (:data:`RANGE` from it); a tensor's elements are read from
    the card (:data:`DATA`)."""
    if not isinstance(data, torch.Tensor) and np.ndim(data) == 0:
        return Plan(RANGE, PAIR, int(data) & _M32, 1, 1, (2,))
    shape = tuple(np.shape(data))
    return Plan(DATA, PAIR, 0, _numel(shape), 1, shape + (2,))


def uniform_params(minval: float, maxval: float) -> dict:
    """The bounds as float32 values held in Python floats; jax's ``floats
    * (maxval - minval) + minval`` rounds as one fused multiply-add, which
    with ``minval == 0`` is a plain multiply."""
    lo = float(np.float32(minval))
    width = float(np.float32(maxval) - np.float32(minval))
    return dict(lo=lo, width=width, use_fma=int(minval != 0.0))


def randint_params(span: int, mult: int, minval: int) -> dict:
    return dict(span=int(span), mult=int(mult), minval=int(minval) & _M32)


def _out_shape(out: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    return shape + (2,) if out == PAIR else shape


def grid_blocks(n: int, sm_count: int) -> int:
    """Blocks for ``n`` elements: one thread an element, at most
    ``BLOCKS_PER_SM`` blocks on each of ``sm_count`` SMs (each thread then
    walks every ``grid * THREADS``-th element)."""
    return max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sm_count))


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# threefry_launch's arguments after the tensors' pointers
_SCALARS = ([ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
            + [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_uint] * 3)
ARGTYPES = [ctypes.c_void_p] * 2 + _SCALARS


def build(verbose: bool = False) -> str:
    """Compile ``csrc/threefry.cu`` into ``build/`` (always) and return
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
        lib.threefry_launch.argtypes = ARGTYPES + [ctypes.c_int,
                                                   ctypes.c_void_p]
        lib.threefry_launch.restype = ctypes.c_int
        _lib = lib
        return lib


def operands(key: torch.Tensor, plan: Plan, idx=None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The key as a contiguous int32[2] and the row ids or data as a
    contiguous int32 or int64 tensor of the plan's length, on the key's
    device (the kernel reads both there)."""
    if key.dtype != torch.int32:
        key = key.to(torch.int32)
    key = key.contiguous()
    if key.numel() != 2:
        raise ValueError(f"threefry: a key has 2 words, got {key.shape}")
    if plan.form == RANGE:
        return key, None
    if idx is None:
        raise ValueError("threefry: this plan reads row ids or data")
    idx = torch.as_tensor(idx, device=key.device)
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int64)
    want = plan.n // plan.inner if plan.form == ROWS else plan.n
    if idx.numel() != want:
        raise ValueError(f"threefry: {idx.numel()} ids, expected {want}")
    return key, idx.contiguous()


def c_args(key: torch.Tensor, idx: Optional[torch.Tensor],
           out: torch.Tensor, plan: Plan) -> tuple:
    """The C entry points' arguments up to the grid (``ARGTYPES``)."""
    return (key.data_ptr(), None if idx is None else idx.data_ptr(),
            0 if idx is None else idx.element_size(), plan.form, plan.out,
            plan.start, plan.n, plan.inner, out.data_ptr(), plan.lo,
            plan.width, plan.use_fma, plan.span, plan.mult, plan.minval)


def threefry(key: torch.Tensor, plan: Plan, idx=None) -> torch.Tensor:
    """One draw (``plan``) under the raw key ``key`` (int32[2] on a CUDA
    card, read there), in one launch; ``idx``: the row ids of a
    :data:`ROWS` plan or the data of a :data:`DATA` plan."""
    with span("kernel.prng"):
        if key.device.type != "cuda":
            raise ValueError(f"threefry: unsupported device {key.device}")
        key, idx = operands(key, plan, idx)
        dev = key.device
        out = torch.empty(plan.shape, dtype=_OUT_DTYPES[plan.out], device=dev)
        if plan.n == 0:
            return out
        lib = _load()
        code = lib.threefry_launch(
            *c_args(key, idx, out, plan), grid_blocks(plan.n, sm_count(dev)),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(code, "threefry launch")
        threefry.launches += 1
        return out


threefry.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch count to 0."""
    threefry.launches = 0
