"""Geometric shape primitives with fitting & intersection helpers
(reference: video/analysis/shapes.py, SURVEY.md §2.1).

The port's copy of ``tpuva/analysis/shapes.py`` (numpy; cv2 imported in
``Ellipse.fit``), held to the original by ``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Circle:
    cx: float
    cy: float
    radius: float

    @property
    def center(self):
        return (self.cx, self.cy)

    @property
    def area(self) -> float:
        return float(np.pi * self.radius**2)

    @property
    def perimeter(self) -> float:
        return float(2 * np.pi * self.radius)

    def contains_point(self, p) -> bool:
        return np.hypot(p[0] - self.cx, p[1] - self.cy) <= self.radius

    def distance_to_point(self, p) -> float:
        """Signed distance to the circle line (negative inside)."""
        return float(np.hypot(p[0] - self.cx, p[1] - self.cy) - self.radius)

    def polyline(self, count: int = 64) -> np.ndarray:
        t = np.linspace(0, 2 * np.pi, count, endpoint=False)
        return np.stack(
            [self.cx + self.radius * np.cos(t), self.cy + self.radius * np.sin(t)],
            axis=1,
        )

    def intersect_line(self, p0, p1):
        """Intersection points of the circle with the infinite line through
        p0, p1 — 0, 1, or 2 (x, y) points."""
        p0 = np.asarray(p0, np.float64)
        d = np.asarray(p1, np.float64) - p0
        f = p0 - np.array([self.cx, self.cy])
        a = d @ d
        b = 2 * (f @ d)
        c = f @ f - self.radius**2
        disc = b * b - 4 * a * c
        if disc < 0 or a == 0:
            return []
        sq = np.sqrt(disc)
        ts = [(-b - sq) / (2 * a), (-b + sq) / (2 * a)]
        pts = [tuple(p0 + t * d) for t in ts]
        return pts[:1] if disc == 0 else pts

    @classmethod
    def fit(cls, points: np.ndarray) -> "Circle":
        """Algebraic least-squares circle fit (Kåsa method)."""
        pts = np.asarray(points, np.float64)
        A = np.column_stack([2 * pts[:, 0], 2 * pts[:, 1], np.ones(len(pts))])
        b = (pts**2).sum(axis=1)
        sol, *_ = np.linalg.lstsq(A, b, rcond=None)
        cx, cy, c = sol
        return cls(float(cx), float(cy), float(np.sqrt(c + cx**2 + cy**2)))


@dataclass
class Ellipse:
    cx: float
    cy: float
    a: float  # semi-major
    b: float  # semi-minor
    angle: float  # radians, major-axis orientation

    @property
    def center(self):
        return (self.cx, self.cy)

    @property
    def area(self) -> float:
        return float(np.pi * self.a * self.b)

    @property
    def eccentricity(self) -> float:
        if self.a == 0:
            return 0.0
        return float(np.sqrt(max(0.0, 1 - (self.b / self.a) ** 2)))

    def contains_point(self, p) -> bool:
        dx, dy = p[0] - self.cx, p[1] - self.cy
        c, s = np.cos(-self.angle), np.sin(-self.angle)
        u = c * dx - s * dy
        v = s * dx + c * dy
        if self.a == 0 or self.b == 0:
            return False
        return (u / self.a) ** 2 + (v / self.b) ** 2 <= 1.0

    def polyline(self, count: int = 64) -> np.ndarray:
        t = np.linspace(0, 2 * np.pi, count, endpoint=False)
        u = self.a * np.cos(t)
        v = self.b * np.sin(t)
        c, s = np.cos(self.angle), np.sin(self.angle)
        return np.stack(
            [self.cx + c * u - s * v, self.cy + s * u + c * v], axis=1
        )

    @classmethod
    def fit(cls, points: np.ndarray) -> "Ellipse":
        """Fit via cv2.fitEllipse (direct least squares)."""
        import cv2

        pts = np.asarray(points, np.float32).reshape(-1, 1, 2)
        (cx, cy), (w, h), deg = cv2.fitEllipse(pts)
        a, b = max(w, h) / 2, min(w, h) / 2
        ang = np.deg2rad(deg + (90.0 if h > w else 0.0))
        return cls(float(cx), float(cy), float(a), float(b), float(ang))

    @classmethod
    def from_moments(cls, mask: np.ndarray) -> "Ellipse":
        """Equivalent ellipse of a binary region from second moments
        (reference: region-shape measurement)."""
        ys, xs = np.nonzero(np.asarray(mask) > 0)
        n = len(xs)
        if n == 0:
            return cls(0, 0, 0, 0, 0)
        cx, cy = xs.mean(), ys.mean()
        mxx = ((xs - cx) ** 2).mean()
        myy = ((ys - cy) ** 2).mean()
        mxy = ((xs - cx) * (ys - cy)).mean()
        common = np.sqrt((mxx - myy) ** 2 + 4 * mxy**2)
        a = np.sqrt(2 * (mxx + myy + common))
        b = np.sqrt(max(0.0, 2 * (mxx + myy - common)))
        ang = 0.5 * np.arctan2(2 * mxy, mxx - myy)
        return cls(float(cx), float(cy), float(a), float(b), float(ang))
