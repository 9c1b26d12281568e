"""Scalar/profile measurements on frames (reference:
video/analysis/image.py): region statistics, line scans, sub-pixel feature
localization (SURVEY.md §2.1).

The port's copy of ``tpuva/analysis/image.py`` (numpy only), held to the
original by ``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

import numpy as np


def get_image_statistics(img: np.ndarray, mask: np.ndarray | None = None):
    """Mean/std/min/max over the image or a masked region."""
    img = np.asarray(img, np.float64)
    if mask is not None:
        vals = img[np.asarray(mask) > 0]
    else:
        vals = img.reshape(-1)
    if vals.size == 0:
        return {"mean": np.nan, "std": np.nan, "min": np.nan, "max": np.nan,
                "count": 0}
    return {
        "mean": float(vals.mean()),
        "std": float(vals.std()),
        "min": float(vals.min()),
        "max": float(vals.max()),
        "count": int(vals.size),
    }


def line_scan(img: np.ndarray, p0, p1, count: int | None = None) -> np.ndarray:
    """Bilinear intensity profile along the segment p0 -> p1 (points are
    (x, y)). Reference: line scans across a mask boundary."""
    img = np.asarray(img, np.float64)
    x0, y0 = p0
    x1, y1 = p1
    if count is None:
        count = int(np.ceil(np.hypot(x1 - x0, y1 - y0))) + 1
    xs = np.linspace(x0, x1, count)
    ys = np.linspace(y0, y1, count)
    return bilinear_sample(img, xs, ys)


def bilinear_sample(img: np.ndarray, xs, ys) -> np.ndarray:
    """Bilinear interpolation at float coordinates (x=col, y=row), edge
    clamped."""
    img = np.asarray(img, np.float64)
    H, W = img.shape[:2]
    xs = np.clip(np.asarray(xs, np.float64), 0, W - 1)
    ys = np.clip(np.asarray(ys, np.float64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 2) if W > 1 else np.zeros_like(xs, int)
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 2) if H > 1 else np.zeros_like(ys, int)
    fx = xs - x0
    fy = ys - y0
    if W == 1:
        fx = np.zeros_like(fx)
    if H == 1:
        fy = np.zeros_like(fy)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


def subpixel_peak_1d(profile: np.ndarray) -> float:
    """Sub-pixel location of the maximum of a 1-D profile via quadratic
    interpolation around the argmax (reference: sub-pixel feature
    localization)."""
    profile = np.asarray(profile, np.float64)
    i = int(np.argmax(profile))
    if i == 0 or i == len(profile) - 1:
        return float(i)
    a, b, c = profile[i - 1], profile[i], profile[i + 1]
    denom = a - 2 * b + c
    if denom == 0:
        return float(i)
    return float(i + 0.5 * (a - c) / denom)


def subpixel_peak_2d(img: np.ndarray) -> tuple[float, float]:
    """Sub-pixel (x, y) of the maximum of a 2-D patch via separable
    quadratic interpolation."""
    img = np.asarray(img, np.float64)
    r, c = np.unravel_index(int(np.argmax(img)), img.shape)
    x = subpixel_peak_1d(img[r, :]) if img.shape[1] >= 3 else float(c)
    y = subpixel_peak_1d(img[:, c]) if img.shape[0] >= 3 else float(r)
    return (x, y)


def get_steepest_point(profile: np.ndarray, direction: int = 1) -> float:
    """Sub-pixel position of the steepest rise (direction=+1) or fall
    (direction=-1) of a 1-D profile — the reference's boundary-crossing
    locator for line scans."""
    profile = np.asarray(profile, np.float64)
    grad = np.gradient(profile) * direction
    return subpixel_peak_1d(grad)


def measure_mean_profile(img, curve, normal_length: float = 5.0,
                         count: int = 11) -> np.ndarray:
    """Mean intensity profile across a curve: for each curve point, sample
    along the local normal (± normal_length) and average over points."""
    curve = np.asarray(curve, np.float64)
    tang = np.gradient(curve, axis=0)
    norm = np.stack([-tang[:, 1], tang[:, 0]], axis=1)
    n = np.linalg.norm(norm, axis=1, keepdims=True)
    norm = np.divide(norm, n, out=np.zeros_like(norm), where=n > 0)
    offsets = np.linspace(-normal_length, normal_length, count)
    profiles = []
    for p, nv in zip(curve, norm):
        xs = p[0] + offsets * nv[0]
        ys = p[1] + offsets * nv[1]
        profiles.append(bilinear_sample(img, xs, ys))
    return np.mean(profiles, axis=0)
