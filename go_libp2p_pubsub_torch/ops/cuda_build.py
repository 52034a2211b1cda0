"""Build and launch helpers shared by the port's CUDA kernel wrappers.

Each kernel source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, in the package's gitignored
``build/`` directory, on first use (``ops/cuda_gossip.py``: K1, K2;
``ops/cuda_ed25519.py``: E1).  The C entry points launch on the stream they
are given and return ``cudaGetLastError()``.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


class KernelBuildError(RuntimeError):
    """nvcc failed to build a kernel library."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (needs the CUDA toolkit)")


def build(source: str, lib_path: str, verbose: bool = False,
          defines: tuple = ()) -> str:
    """Compile ``source`` into ``lib_path`` (always) and return nvcc's
    output (``-Xptxas -v`` register/stack/spill report when ``verbose``).
    ``defines``: ``NAME=value`` macros for the build (a sweep's variant)."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           *(f"-D{d}" for d in defines), "-Xcompiler", "-fPIC", "-o", tmp,
           source]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return proc.stdout + proc.stderr


def stale(source: str, lib_path: str) -> bool:
    """True if ``lib_path`` is missing or older than ``source``."""
    return not os.path.exists(lib_path) or (
        os.path.getmtime(source) > os.path.getmtime(lib_path))


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


_sm_counts = {}


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of CUDA device ``dev`` (cached)."""
    index = device_index(dev)
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
