"""Polyline/curve analysis (reference: video/analysis/curves.py).

Free functions over (N, 2) float arrays of (x, y) points: arc length,
equidistant resampling, Douglas-Peucker simplification, point-to-curve
distance, smoothing/spline fits — used for elongated-object centerlines in
the application layer (SURVEY.md §2.1).

The port's copy of ``tpuva/analysis/curves.py`` (numpy only;
``app/tracks.py`` needs ``smooth_curve``), held to the original by
``tests/test_torch_app.py``.
"""

from __future__ import annotations

import numpy as np


def curve_length(curve: np.ndarray) -> float:
    """Total arc length of the polyline."""
    curve = np.asarray(curve, np.float64)
    if len(curve) < 2:
        return 0.0
    return float(np.linalg.norm(np.diff(curve, axis=0), axis=1).sum())


def make_curve_equidistant(curve: np.ndarray, spacing: float | None = None,
                           count: int | None = None) -> np.ndarray:
    """Resample the polyline to points equidistant in arc length.

    Give either `spacing` (target distance between points) or `count`
    (number of output points). Endpoints are preserved.
    """
    curve = np.asarray(curve, np.float64)
    if len(curve) < 2:
        return curve.copy()
    seg = np.linalg.norm(np.diff(curve, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    if total == 0:
        return curve[:1].repeat(count or 2, axis=0)
    if count is None:
        if spacing is None:
            raise ValueError("give spacing or count")
        count = max(2, int(round(total / spacing)) + 1)
    targets = np.linspace(0.0, total, count)
    x = np.interp(targets, s, curve[:, 0])
    y = np.interp(targets, s, curve[:, 1])
    return np.stack([x, y], axis=1)


def simplify_curve(curve: np.ndarray, tolerance: float) -> np.ndarray:
    """Douglas-Peucker polyline simplification (reference: simplify_curve;
    matches cv2.approxPolyDP for open curves)."""
    curve = np.asarray(curve, np.float64)
    n = len(curve)
    if n < 3:
        return curve.copy()
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 <= i0 + 1:
            continue
        seg = curve[i1] - curve[i0]
        seg_len = np.hypot(*seg)
        pts = curve[i0 + 1 : i1]
        if seg_len == 0:
            d = np.linalg.norm(pts - curve[i0], axis=1)
        else:
            rel = pts - curve[i0]
            d = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / seg_len
        imax = int(np.argmax(d))
        if d[imax] > tolerance:
            k = i0 + 1 + imax
            keep[k] = True
            stack.append((i0, k))
            stack.append((k, i1))
    return curve[keep]


def point_distance(p, q) -> float:
    return float(np.hypot(p[0] - q[0], p[1] - q[1]))


def point_to_segment_distance(p, a, b):
    """Distance from point p to segment [a, b] and the foot parameter
    t in [0, 1]."""
    p = np.asarray(p, np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ab = b - a
    denom = float(ab @ ab)
    t = 0.0 if denom == 0 else float(np.clip((p - a) @ ab / denom, 0.0, 1.0))
    foot = a + t * ab
    return float(np.linalg.norm(p - foot)), t


def curve_distance(p, curve: np.ndarray):
    """Min distance from point p to the polyline, plus the arc-length
    position of the closest point (reference: point-to-curve distances)."""
    curve = np.asarray(curve, np.float64)
    if len(curve) == 1:
        return point_distance(p, curve[0]), 0.0
    seg_len = np.linalg.norm(np.diff(curve, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg_len)])
    best = (np.inf, 0.0)
    for i in range(len(curve) - 1):
        d, t = point_to_segment_distance(p, curve[i], curve[i + 1])
        if d < best[0]:
            best = (d, s[i] + t * seg_len[i])
    return best


def average_normalized_curves(curves, count: int = 64) -> np.ndarray:
    """Mean curve after equidistant resampling of each input."""
    resampled = [make_curve_equidistant(c, count=count) for c in curves]
    return np.mean(resampled, axis=0)


def smooth_curve(curve: np.ndarray, window: int = 5) -> np.ndarray:
    """Moving-average smoothing with endpoint preservation."""
    curve = np.asarray(curve, np.float64)
    if len(curve) < 3 or window < 3:
        return curve.copy()
    window = min(window | 1, len(curve) | 1)  # odd
    pad = window // 2
    padded = np.pad(curve, ((pad, pad), (0, 0)), mode="edge")
    kernel = np.ones(window) / window
    out = np.stack(
        [np.convolve(padded[:, d], kernel, mode="valid") for d in (0, 1)],
        axis=1,
    )
    out[0] = curve[0]
    out[-1] = curve[-1]
    return out


def fit_spline(curve: np.ndarray, count: int = 100, smoothing: float = 0.0):
    """Smoothing-spline fit through the polyline, resampled to `count`
    points (reference: scipy.interpolate spline fits)."""
    from scipy import interpolate

    curve = np.asarray(curve, np.float64)
    if len(curve) < 4:
        return make_curve_equidistant(curve, count=count)
    tck, _u = interpolate.splprep(curve.T, s=smoothing)
    u = np.linspace(0, 1, count)
    x, y = interpolate.splev(u, tck)
    return np.stack([x, y], axis=1)


def curve_from_mask_skeleton(mask: np.ndarray) -> np.ndarray:
    """Crude centerline of an elongated blob: per-column (or per-row,
    whichever is longer) mean of mask pixels, ordered along the major
    axis. Good enough as an initial curve for ActiveContour refinement."""
    ys, xs = np.nonzero(np.asarray(mask) > 0)
    if len(xs) == 0:
        return np.zeros((0, 2))
    if np.ptp(xs) >= np.ptp(ys):
        cols, order = np.unique(xs, return_inverse=True)
        means = np.zeros(len(cols))
        np.add.at(means, order, ys)
        counts = np.bincount(order)
        return np.stack([cols, means / counts], axis=1)
    rows, order = np.unique(ys, return_inverse=True)
    means = np.zeros(len(rows))
    np.add.at(means, order, xs)
    counts = np.bincount(order)
    return np.stack([means / counts, rows], axis=1)
