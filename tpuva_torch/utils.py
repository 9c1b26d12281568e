"""Copies of ``tpuva/utils.py``'s jax-free helpers: ``BatchLogger``, per-batch
progress logging (pinned to the original by
``tests/test_torch_streaming.py``), and ``ensure_directory_exists``
(``tests/test_torch_app.py``)."""

from __future__ import annotations

import json
import os
import sys
import time


class BatchLogger:
    """Structured per-batch log line (SURVEY.md §5.5): fps, queue depth,
    active tracks — emitted as JSON for machine consumption, throttled for
    humans."""

    def __init__(self, out=sys.stderr, every: float = 1.0, enabled: bool = True):
        self._out = out
        self.every = every
        self.enabled = enabled
        self._last = 0.0
        self._t0 = time.monotonic()
        self.frames = 0

    def log(self, batch_frames: int, **fields):
        self.frames += batch_frames
        now = time.monotonic()
        if not self.enabled or now - self._last < self.every:
            return
        self._last = now
        rec = {
            "t": round(now - self._t0, 3),
            "frames": self.frames,
            "fps": round(self.frames / max(now - self._t0, 1e-9), 1),
            **fields,
        }
        self._out.write(json.dumps(rec) + "\n")
        self._out.flush()


def ensure_directory_exists(path: str) -> str:
    """Create the directory (and parents) if missing; returns the path."""
    if path and not os.path.isdir(path):
        os.makedirs(path, exist_ok=True)
    return path
