"""Trajectory CSV writer and reader — a copy of ``tpuva/export/csvio.py``.

Identical rows give identical bytes; ``tests/test_torch_pipeline.py``
pins this copy to the original byte for byte.
Row schema: (track_id:int, frame:int, x:float, y:float, area:int), sorted
by (track_id, frame).
"""

from __future__ import annotations

import numpy as np

HEADER = "track_id,frame,x,y,area"


def format_rows(rows) -> str:
    """rows: iterable of (track_id, frame, x, y, area)."""
    rows = sorted(rows, key=lambda r: (int(r[0]), int(r[1])))
    lines = [HEADER]
    for tid, frame, x, y, area in rows:
        lines.append(f"{int(tid)},{int(frame)},{x:.3f},{y:.3f},{int(round(area))}")
    return "\n".join(lines) + "\n"


def write_tracks_csv(path, rows) -> None:
    with open(path, "w") as fh:
        fh.write(format_rows(rows))


def read_tracks_csv(path) -> np.ndarray:
    """Returns (N, 5) float64 array of (track_id, frame, x, y, area)."""
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2, dtype=np.float64)
    if data.size == 0:
        return np.zeros((0, 5), np.float64)
    return data
