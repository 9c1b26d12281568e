"""Trajectory CSV writer — a copy of ``tpuva/export/csvio.py``'s writer.

Identical rows give identical bytes; ``tests/test_torch_pipeline.py``
pins this copy to the original byte for byte.
Row schema: (track_id:int, frame:int, x:float, y:float, area:int), sorted
by (track_id, frame).
"""

from __future__ import annotations

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
