"""Copies of ``tpuva/utils.py``'s jax-free helpers: ``BatchLogger``, per-batch
progress logging (pinned to the original by
``tests/test_torch_streaming.py``), ``ensure_directory_exists``
(``tests/test_torch_app.py``), ``prepare_data_for_yaml`` and
``display_progress`` (``tests/test_torch_public_functions.py``)."""

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


def prepare_data_for_yaml(data):
    """Recursively convert numpy scalars/arrays to plain python types for
    serialization (reference had a YAML-prep helper of this shape)."""
    import numpy as np

    if isinstance(data, dict):
        return {k: prepare_data_for_yaml(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return [prepare_data_for_yaml(v) for v in data]
    if isinstance(data, np.ndarray):
        return data.tolist()
    if isinstance(data, np.generic):
        return data.item()
    return data


class display_progress:
    """Console progress reporter for long frame loops (reference:
    video/utils.py progress helper). Iterable wrapper:

        for frame in display_progress(video):
            ...
    """

    def __init__(self, iterable, total=None, label: str = "", every: float = 0.5,
                 out=sys.stderr):
        self._iterable = iterable
        self.total = total if total is not None else _maybe_len(iterable)
        self.label = label
        self.every = every
        self._out = out

    def __iter__(self):
        start = last = time.monotonic()
        count = 0
        for item in self._iterable:
            yield item
            count += 1
            now = time.monotonic()
            if now - last >= self.every:
                last = now
                self._print(count, now - start)
        self._print(count, time.monotonic() - start, final=True)

    def _print(self, count, elapsed, final=False):
        rate = count / elapsed if elapsed > 0 else 0.0
        if self.total:
            pct = 100.0 * count / self.total
            msg = (
                f"\r{self.label}{count}/{self.total} ({pct:5.1f}%) "
                f"{rate:7.1f}/s"
            )
        else:
            msg = f"\r{self.label}{count} ({rate:7.1f}/s)"
        self._out.write(msg + ("\n" if final else ""))
        self._out.flush()


def _maybe_len(obj):
    try:
        return len(obj)
    except TypeError:
        return None
