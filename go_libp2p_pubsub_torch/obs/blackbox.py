"""Flight black box: a bounded ring of per-chunk telemetry frames.

The engine records one frame per chunk (queue depth, verify latency, shed
and dedup counters, chunk wall time); the ring keeps the last K, so when
the watchdog restarts a wedged engine it can dump the run-up to the death —
the post-mortem a crashed serving plane otherwise reduces to final
counters.  The dump is a plain JSON file through the same
write→fsync→rename discipline as ``utils.checkpoint``, so a crash *during*
the dump never leaves a truncated artifact shadowing the story.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional


class BlackBox:
    """Last-K frame ring.  Host-side, lock-free by ownership: the engine
    thread records, the watchdog dumps from the same serving loop."""

    def __init__(self, capacity: int = 64, clock=time.monotonic) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._clock = clock
        self._frames: deque = deque(maxlen=self.capacity)
        self.recorded = 0

    def record(self, frame: Dict[str, Any]) -> None:
        f = dict(frame)
        f.setdefault("t", float(self._clock()))
        self._frames.append(f)
        self.recorded += 1

    def frames(self) -> List[Dict[str, Any]]:
        return [dict(f) for f in self._frames]

    def __len__(self) -> int:
        return len(self._frames)

    def dump(self, path: str, extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the post-mortem JSON atomically; returns ``path``."""
        doc = {
            "format": "obs-blackbox/1",
            "dumped_t": float(self._clock()),
            "capacity": self.capacity,
            "recorded": self.recorded,
            "frames": self.frames(),
        }
        if extra:
            doc["extra"] = extra
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path
