"""Trajectory containers (reference: companion-project Track /
TrackCollection-style classes, SURVEY.md §2.1).

Tracks are built from the pipeline's trajectory rows and support the
post-processing the reference's later passes performed: gap-aware
stitching, interpolation, smoothing, and per-track statistics.

The port's copy of ``tpuva/app/tracks.py``, held to the original by
``tests/test_torch_app.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Track:
    id: int
    frames: np.ndarray  # (T,) int
    positions: np.ndarray  # (T, 2) float (x, y)
    areas: np.ndarray  # (T,) float

    @property
    def start(self) -> int:
        return int(self.frames[0])

    @property
    def end(self) -> int:
        return int(self.frames[-1])

    @property
    def duration(self) -> int:
        return self.end - self.start + 1

    def __len__(self) -> int:
        return len(self.frames)

    @property
    def first_position(self):
        return tuple(self.positions[0])

    @property
    def last_position(self):
        return tuple(self.positions[-1])

    def path_length(self) -> float:
        if len(self.positions) < 2:
            return 0.0
        return float(
            np.linalg.norm(np.diff(self.positions, axis=0), axis=1).sum()
        )

    def displacement(self) -> float:
        return float(np.linalg.norm(self.positions[-1] - self.positions[0]))

    def mean_speed(self) -> float:
        """Mean per-frame speed over the track's span."""
        if self.duration <= 1:
            return 0.0
        return self.path_length() / (self.duration - 1)

    def mean_area(self) -> float:
        return float(self.areas.mean()) if len(self.areas) else 0.0

    def position_at(self, frame: int):
        """Position at a frame, linearly interpolated across gaps."""
        x = np.interp(frame, self.frames, self.positions[:, 0])
        y = np.interp(frame, self.frames, self.positions[:, 1])
        return (float(x), float(y))

    def interpolated(self) -> "Track":
        """Fill missed frames by linear interpolation (reference pass-2
        behavior for short occlusions)."""
        full = np.arange(self.start, self.end + 1)
        x = np.interp(full, self.frames, self.positions[:, 0])
        y = np.interp(full, self.frames, self.positions[:, 1])
        a = np.interp(full, self.frames, self.areas)
        return Track(self.id, full, np.stack([x, y], 1), a)

    def smoothed(self, window: int = 5) -> "Track":
        from tpuva_torch.analysis.curves import smooth_curve

        return Track(
            self.id, self.frames.copy(),
            smooth_curve(self.positions, window), self.areas.copy(),
        )

    def to_rows(self):
        return [
            (self.id, int(f), float(p[0]), float(p[1]), float(a))
            for f, p, a in zip(self.frames, self.positions, self.areas)
        ]


@dataclass
class TrackCollection:
    tracks: list = field(default_factory=list)

    @staticmethod
    def from_rows(rows) -> "TrackCollection":
        """rows: (track_id, frame, x, y, area) tuples."""
        by_id: dict[int, list] = {}
        for tid, frame, x, y, area in rows:
            by_id.setdefault(int(tid), []).append(
                (int(frame), float(x), float(y), float(area))
            )
        tracks = []
        for tid in sorted(by_id):
            entries = sorted(by_id[tid])
            arr = np.array(entries, np.float64)
            tracks.append(
                Track(
                    tid,
                    arr[:, 0].astype(int),
                    arr[:, 1:3],
                    arr[:, 3],
                )
            )
        return TrackCollection(tracks)

    def __len__(self):
        return len(self.tracks)

    def __iter__(self):
        return iter(self.tracks)

    def __getitem__(self, i):
        return self.tracks[i]

    def by_id(self, tid: int) -> Track:
        for t in self.tracks:
            if t.id == tid:
                return t
        raise KeyError(tid)

    def to_rows(self):
        rows = []
        for t in self.tracks:
            rows.extend(t.to_rows())
        return rows

    # ------------------------------------------------------- post-processing
    def filter_short(self, min_length: int) -> "TrackCollection":
        return TrackCollection(
            [t for t in self.tracks if len(t) >= min_length]
        )

    def stitch(self, max_gap: int = 10, max_dist: float = 40.0
               ) -> "TrackCollection":
        """Join tracks across detection gaps (reference pass-2 "track
        stitching"): track B is appended to track A when B starts within
        `max_gap` frames after A ends (strictly after: time-overlapping
        tracks are distinct objects and never merge) and within `max_dist`
        px of A's last position. Greedy in track-start order; among
        multiple candidate predecessors the match is deterministic
        cheapest-first: smallest distance, ties broken by smaller gap,
        then earlier start, then lower id. Merged tracks keep the
        predecessor's id, and its extended endpoint is what later tracks
        stitch against (chains A<-B<-C collapse to one track).
        """
        tracks = sorted(self.tracks, key=lambda t: (t.start, t.id))
        merged: list[Track] = []
        open_tracks: list[Track] = []
        for t in tracks:
            best = None
            best_key = None
            for o in open_tracks:
                gap = t.start - o.end
                if 0 < gap <= max_gap:
                    d = float(
                        np.linalg.norm(
                            np.array(t.first_position)
                            - np.array(o.last_position)
                        )
                    )
                    key = (d, gap, o.start, o.id)
                    if d <= max_dist and (best_key is None or key < best_key):
                        best, best_key = o, key
            if best is not None:
                best.frames = np.concatenate([best.frames, t.frames])
                best.positions = np.concatenate([best.positions, t.positions])
                best.areas = np.concatenate([best.areas, t.areas])
            else:
                open_tracks.append(t)
                merged.append(t)
        return TrackCollection(merged)

    def summary(self) -> list[dict]:
        return [
            {
                "id": t.id,
                "start": t.start,
                "end": t.end,
                "points": len(t),
                "path_length": round(t.path_length(), 3),
                "displacement": round(t.displacement(), 3),
                "mean_speed": round(t.mean_speed(), 4),
                "mean_area": round(t.mean_area(), 2),
            }
            for t in self.tracks
        ]
