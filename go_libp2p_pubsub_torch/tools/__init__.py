"""The system's command-line tools, run on the port.

Each is ``python -m go_libp2p_pubsub_torch.tools.<name>``:

- ``scenario_run`` -- run canon or spec-file campaigns on the sim,
  streaming or live plane and print their SLO verdicts; save and replay
  traces;
- ``trace_view`` -- summarise a ``--trace-out`` observability artifact,
  or merge a traced live run's per-host ledgers;
- ``scenario_fuzz`` -- seeded search for SLO-red campaigns (or fragile
  defense configs), with a shrinker;
- ``coevolve`` -- the alternating attack / defense search, its invariant
  and promotion gates and its audit document;
- ``mem_audit`` -- per-buffer resident bytes of every model family's
  state, narrow against int32 index planes, extrapolated by peer count.

They keep the JAX package's tools' flags, output and exit codes (its
``tools/`` directory), plus ``--device`` (default ``cuda``) where a tool
runs campaigns or models: where those run.  Without a card, ``--device
cuda`` stops the tool with exit code 2 before anything runs.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..ops.cuda_build import KernelBuildError

_OPS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ops")
# torch's own errors of a device: a failed launch or a fault, no memory.
_TORCH_DEVICE_ERRORS = (torch.AcceleratorError, torch.cuda.CudaError,
                        torch.cuda.DeferredCudaCallError,
                        torch.cuda.OutOfMemoryError)


def device_error(device: str) -> Optional[str]:
    """Why the tools cannot run on ``device``, or None when they can."""
    try:
        dev = torch.device(device)
    except RuntimeError as e:
        return f"--device {device!r}: {e}"
    if dev.type == "cuda" and not torch.cuda.is_available():
        return (f"--device {device}: CUDA is not available "
                f"(--device cpu runs on the CPU)")
    return None


def device_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is the device's failure, not the campaign's: a
    kernel library that did not build, an error raised inside a kernel
    wrapper (``ops/cuda_*.py``: its input checks and its launch status),
    or one of torch's own device errors.  Decided by type and by where it
    was raised, never by its message."""
    if isinstance(exc, (KernelBuildError,) + _TORCH_DEVICE_ERRORS):
        return True
    tb = exc.__traceback__
    while tb is not None:
        path = tb.tb_frame.f_code.co_filename
        if (os.path.dirname(os.path.abspath(path)) == _OPS_DIR
                and os.path.basename(path).startswith("cuda_")):
            return True
        tb = tb.tb_next
    return False
