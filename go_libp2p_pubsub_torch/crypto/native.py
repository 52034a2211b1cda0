"""ctypes binding of the native C++ batched ed25519 (``native/ed25519/``).

A copy of the JAX package's ``crypto/native.py`` (which the port cannot
import without pulling in JAX); it re-exports ``signing_bytes`` and
``Envelope`` from the port's ``crypto/pipeline.py``.  The library is built
from the shared
source ``native/ed25519/ed25519.cpp`` with ``g++`` on first use, into the
port's own build directory (``go_libp2p_pubsub_torch/build/``), never
next to the sources.

API (batched and thread-parallel in C++): :func:`verify_batch`,
:func:`sign_batch`, :func:`public_key_batch`; one at a time:
:func:`sha512`, :func:`public_key`, :func:`sign`, :func:`verify`;
:func:`available`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from .pipeline import Envelope, signing_bytes  # noqa: F401  (re-exported)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native", "ed25519")
SOURCE = os.path.join(_SRC_DIR, "ed25519.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libed25519.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The g++ build of the native library failed."""


def build() -> None:
    """Compile the shared ed25519 source into the port's build directory."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
        "-o", tmp, SOURCE,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=_SRC_DIR)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native ed25519 build failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(LIB_PATH) or (
            os.path.getmtime(SOURCE) > os.path.getmtime(LIB_PATH)
        ):
            build()
        lib = ctypes.CDLL(LIB_PATH)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.ed25519_verify_batch.argtypes = [
            u8p, u8p, u8p, u64p, ctypes.c_int64, ctypes.c_int, u8p,
        ]
        lib.ed25519_verify_batch.restype = None
        lib.ed25519_sign_batch.argtypes = [
            u8p, u8p, u64p, ctypes.c_int64, ctypes.c_int, u8p,
        ]
        lib.ed25519_sign_batch.restype = None
        lib.ed25519_public_key_batch.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int, u8p,
        ]
        lib.ed25519_public_key_batch.restype = None
        lib.ed25519_sha512.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.ed25519_sha512.restype = None
        lib.ed25519_verify.argtypes = [u8p, u8p, u8p, ctypes.c_uint64]
        lib.ed25519_verify.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """True if the native library is present or buildable."""
    try:
        _load()
        return True
    except (NativeBuildError, OSError):
        return False


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _concat_msgs(msgs: Sequence[bytes]):
    offs = np.zeros(len(msgs) + 1, dtype=np.uint64)
    np.cumsum([len(m) for m in msgs], out=offs[1:])
    blob = np.frombuffer(b"".join(msgs), dtype=np.uint8) if msgs else np.zeros(
        0, np.uint8)
    if blob.size == 0:
        blob = np.zeros(1, np.uint8)  # valid pointer for empty batches
    return np.ascontiguousarray(blob), offs


def _threads(n: int, threads: Optional[int]) -> int:
    if threads is not None:
        return max(1, threads)
    return max(1, min(os.cpu_count() or 1, n))


def verify_batch(
    pks: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    threads: Optional[int] = None,
) -> np.ndarray:
    """Verify n signatures in parallel; returns bool[n]."""
    n = len(pks)
    if not (n == len(msgs) == len(sigs)):
        raise ValueError("pks/msgs/sigs length mismatch")
    if n == 0:
        return np.zeros(0, bool)
    lib = _load()
    pk_arr = np.frombuffer(b"".join(pks), dtype=np.uint8).copy()
    sig_arr = np.frombuffer(b"".join(sigs), dtype=np.uint8).copy()
    if pk_arr.size != 32 * n or sig_arr.size != 64 * n:
        raise ValueError("pks must be 32 bytes and sigs 64 bytes each")
    blob, offs = _concat_msgs(msgs)
    out = np.zeros(n, np.uint8)
    lib.ed25519_verify_batch(
        _as_u8p(pk_arr), _as_u8p(sig_arr), _as_u8p(blob),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n, _threads(n, threads), _as_u8p(out),
    )
    return out.astype(bool)


def sign_batch(
    seeds: Sequence[bytes], msgs: Sequence[bytes],
    threads: Optional[int] = None,
) -> List[bytes]:
    """Sign n messages in parallel; returns n 64-byte signatures."""
    n = len(seeds)
    if n != len(msgs):
        raise ValueError("seeds/msgs length mismatch")
    if n == 0:
        return []
    lib = _load()
    seed_arr = np.frombuffer(b"".join(seeds), dtype=np.uint8).copy()
    if seed_arr.size != 32 * n:
        raise ValueError("seeds must be 32 bytes each")
    blob, offs = _concat_msgs(msgs)
    out = np.zeros(64 * n, np.uint8)
    lib.ed25519_sign_batch(
        _as_u8p(seed_arr), _as_u8p(blob),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n, _threads(n, threads), _as_u8p(out),
    )
    raw = out.tobytes()
    return [raw[64 * i : 64 * (i + 1)] for i in range(n)]


def public_key_batch(
    seeds: Sequence[bytes], threads: Optional[int] = None
) -> List[bytes]:
    """The 32-byte public key of each 32-byte seed."""
    n = len(seeds)
    if n == 0:
        return []
    lib = _load()
    seed_arr = np.frombuffer(b"".join(seeds), dtype=np.uint8).copy()
    if seed_arr.size != 32 * n:
        raise ValueError("seeds must be 32 bytes each")
    out = np.zeros(32 * n, np.uint8)
    lib.ed25519_public_key_batch(
        _as_u8p(seed_arr), n, _threads(n, threads), _as_u8p(out)
    )
    raw = out.tobytes()
    return [raw[32 * i : 32 * (i + 1)] for i in range(n)]


def public_key(seed: bytes) -> bytes:
    """The 32-byte public key of one 32-byte seed."""
    if len(seed) != 32:
        raise ValueError(f"seed must be 32 bytes, got {len(seed)}")
    return public_key_batch([seed], threads=1)[0]


def sign(seed: bytes, msg: bytes) -> bytes:
    """The 64-byte signature of ``msg`` under one 32-byte seed."""
    if len(seed) != 32:
        raise ValueError(f"seed must be 32 bytes, got {len(seed)}")
    return sign_batch([seed], [msg], threads=1)[0]


def sha512(msg: bytes) -> bytes:
    """The 64-byte SHA-512 digest of ``msg`` (the library's own hash)."""
    lib = _load()
    m = np.frombuffer(msg, dtype=np.uint8) if msg else np.zeros(1, np.uint8)
    out = np.zeros(64, np.uint8)
    lib.ed25519_sha512(_as_u8p(np.ascontiguousarray(m)), len(msg),
                       _as_u8p(out))
    return out.tobytes()


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """One signature's verdict."""
    # Malformed authenticators are a defined reject, matching ed25519_ref:
    # the C side reads exactly 32/64 bytes and must never read past a short
    # buffer.
    if len(pk) != 32 or len(sig) != 64:
        return False
    lib = _load()
    p = np.frombuffer(pk, dtype=np.uint8).copy()
    g = np.frombuffer(sig, dtype=np.uint8).copy()
    m = np.frombuffer(msg, dtype=np.uint8) if msg else np.zeros(1, np.uint8)
    return bool(lib.ed25519_verify(
        _as_u8p(p), _as_u8p(g), _as_u8p(np.ascontiguousarray(m)), len(msg)))
