"""Rectangle algebra and mask/region operations (reference:
video/analysis/regions.py).

The reference leaned on shapely for polygon booleans; shapely is absent
here and only rectangle algebra + contour/outline ops are on the
capability path (SURVEY.md §8), so those are implemented directly in
numpy/cv2.

Convention: x = column, y = row (OpenCV), rectangles are (x, y, width,
height) with integer or float fields.

The port's copy of ``tpuva/analysis/regions.py``, held to the original by
``tests/test_torch_analysis.py``; ``mask_boundary`` takes a tensor and
erodes on its device (kernel K1m on a card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Rectangle:
    x: float
    y: float
    width: float
    height: float

    # ------------------------------------------------------------ altctors
    @classmethod
    def from_points(cls, p1, p2) -> "Rectangle":
        """From two opposite corners (any order)."""
        x1, y1 = p1
        x2, y2 = p2
        return cls(min(x1, x2), min(y1, y2), abs(x2 - x1), abs(y2 - y1))

    @classmethod
    def from_centerpoint(cls, center, width, height) -> "Rectangle":
        cx, cy = center
        return cls(cx - width / 2, cy - height / 2, width, height)

    @classmethod
    def from_mask(cls, mask: np.ndarray) -> "Rectangle":
        """Tight bounding box of a binary mask (width/height in pixels,
        inclusive of the last pixel)."""
        ys, xs = np.nonzero(mask)
        if len(xs) == 0:
            return cls(0, 0, 0, 0)
        return cls(
            int(xs.min()),
            int(ys.min()),
            int(xs.max() - xs.min() + 1),
            int(ys.max() - ys.min() + 1),
        )

    # ----------------------------------------------------------- properties
    @property
    def left(self):
        return self.x

    @property
    def right(self):
        return self.x + self.width

    @property
    def top(self):
        return self.y

    @property
    def bottom(self):
        return self.y + self.height

    @property
    def corners(self):
        """((x0, y0), (x1, y1)) of the top-left / bottom-right corners."""
        return (self.x, self.y), (self.right, self.bottom)

    @property
    def center(self):
        return (self.x + self.width / 2, self.y + self.height / 2)

    @property
    def area(self):
        return max(0.0, self.width) * max(0.0, self.height)

    @property
    def is_empty(self) -> bool:
        return self.width <= 0 or self.height <= 0

    # ------------------------------------------------------------- algebra
    def buffer(self, amount) -> "Rectangle":
        """Expand (or shrink, if negative) by `amount` on every side."""
        return Rectangle(
            self.x - amount,
            self.y - amount,
            self.width + 2 * amount,
            self.height + 2 * amount,
        )

    def translate(self, dx, dy) -> "Rectangle":
        return Rectangle(self.x + dx, self.y + dy, self.width, self.height)

    def scale(self, factor) -> "Rectangle":
        return Rectangle(
            self.x * factor, self.y * factor,
            self.width * factor, self.height * factor,
        )

    def intersection(self, other: "Rectangle") -> "Rectangle":
        x0 = max(self.left, other.left)
        y0 = max(self.top, other.top)
        x1 = min(self.right, other.right)
        y1 = min(self.bottom, other.bottom)
        return Rectangle(x0, y0, max(0.0, x1 - x0), max(0.0, y1 - y0))

    def union(self, other: "Rectangle") -> "Rectangle":
        """Smallest rectangle covering both."""
        x0 = min(self.left, other.left)
        y0 = min(self.top, other.top)
        return Rectangle(
            x0,
            y0,
            max(self.right, other.right) - x0,
            max(self.bottom, other.bottom) - y0,
        )

    def intersects(self, other: "Rectangle") -> bool:
        return not self.intersection(other).is_empty

    def overlap_fraction(self, other: "Rectangle") -> float:
        """Intersection-over-union."""
        inter = self.intersection(other).area
        union = self.area + other.area - inter
        return inter / union if union > 0 else 0.0

    def contains_point(self, p) -> bool:
        x, y = p
        return self.left <= x < self.right and self.top <= y < self.bottom

    def clip_to(self, width, height) -> "Rectangle":
        """Clip to an image of (width, height)."""
        return self.intersection(Rectangle(0, 0, width, height))

    def to_int(self) -> "Rectangle":
        """Integer-aligned cover (floor origin, ceil far edge)."""
        x0, y0 = int(np.floor(self.x)), int(np.floor(self.y))
        x1 = int(np.ceil(self.right))
        y1 = int(np.ceil(self.bottom))
        return Rectangle(x0, y0, x1 - x0, y1 - y0)

    def slices(self):
        """(row_slice, col_slice) for numpy indexing."""
        r = self.to_int()
        return (
            slice(int(r.y), int(r.y + r.height)),
            slice(int(r.x), int(r.x + r.width)),
        )


# --------------------------------------------------------------- mask utils
def corners_to_rect(p1, p2) -> Rectangle:
    return Rectangle.from_points(p1, p2)


def rect_to_corners(rect: Rectangle):
    return rect.corners


def rect_to_slices(rect: Rectangle):
    return rect.slices()


def expand_rectangle(rect: Rectangle, amount) -> Rectangle:
    return rect.buffer(amount)


def get_enclosing_outline(points: np.ndarray) -> np.ndarray:
    """Convex hull of an (N, 2) point set as an (M, 2) closed polyline
    (reference: enclosing outlines of point sets; cv2.convexHull)."""
    import cv2

    pts = np.asarray(points, np.float32).reshape(-1, 1, 2)
    hull = cv2.convexHull(pts).reshape(-1, 2)
    return np.concatenate([hull, hull[:1]], axis=0)


def mask_to_contours(mask: np.ndarray):
    """Outer contours of a binary mask as a list of (N, 2) float arrays of
    (x, y) points (reference: mask<->contour conversion;
    cv2.findContours RETR_EXTERNAL/CHAIN_APPROX_SIMPLE, SURVEY.md §2.2)."""
    import cv2

    mask = (np.asarray(mask) > 0).astype(np.uint8)
    contours, _ = cv2.findContours(
        mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    return [c.reshape(-1, 2).astype(np.float64) for c in contours]


def contour_to_mask(contour: np.ndarray, shape) -> np.ndarray:
    """Filled polygon mask from an (N, 2) contour of (x, y) points."""
    import cv2

    mask = np.zeros(shape, np.uint8)
    cv2.fillPoly(mask, [np.asarray(contour, np.int32).reshape(-1, 1, 2)], 255)
    return mask


def mask_boundary(mask):
    """Boundary pixels of a mask (..., H, W) tensor (mask minus its 3 x 3
    rect erosion, cv2's constant border) as a bool tensor on its device.
    The erosion is ops.filters.erode over the frames: one launch of kernel
    K1m on a CUDA tensor, _morph on a CPU one."""
    import torch

    from tpuva_torch.ops.filters import erode, structuring_element

    m = mask > 0
    x = m.to(torch.uint8)
    er = erode(x.reshape((-1,) + x.shape[-2:]), structuring_element("rect", 3))
    return m & (er.reshape(x.shape) == 0)
