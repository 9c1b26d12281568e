"""On-the-fly synthetic video source (config-4 scale testing: 100k+-frame
streams don't fit in host RAM, BASELINE.json:10).

Renders the same moving-blob scenes as refimpl.synthetic, but per frame /
per batch at iteration time, with analytic ground-truth trajectories.

The port's copy of ``tpuva/io/synthetic.py`` (jax-free there too);
``tests/test_torch_io.py`` holds it to the original on the same files and
seeds.
"""

from __future__ import annotations

import numpy as np

from tpuva_torch.io.base import VideoBase


class SyntheticVideo(VideoBase):
    """Bouncing-disk scene rendered on demand. Deterministic in the frame
    index (positions are closed-form), so random access and repeated
    iteration agree exactly."""

    def __init__(
        self,
        h: int = 1080,
        w: int = 1920,
        frames: int = 100_000,
        n_blobs: int = 4,
        radius: float = 16.0,
        bg_level: int = 20,
        fg_level: int = 220,
        fps: float = 30.0,
        seed: int = 0,
    ):
        super().__init__(frames, (w, h), fps, is_color=False)
        rng = np.random.default_rng(seed)
        self.radius = radius
        self.bg_level = bg_level
        self.fg_level = fg_level
        m = radius + 4
        self._m = m
        self._p0 = np.stack(
            [rng.uniform(m, w - m, n_blobs), rng.uniform(m, h - m, n_blobs)],
            axis=1,
        )
        self._v = rng.uniform(2.0, 6.0, (n_blobs, 2)) * rng.choice(
            [-1.0, 1.0], (n_blobs, 2)
        )
        self.plate = np.full((h, w), bg_level, np.uint8)

    def positions(self, t: int) -> np.ndarray:
        """Analytic (n_blobs, 2) positions at frame t (triangle-wave
        bounce)."""
        w, h = self.size
        m = self._m
        out = np.empty_like(self._p0)
        for d, lim in ((0, w), (1, h)):
            span = lim - 2 * m
            x = (self._p0[:, d] - m) + self._v[:, d] * t
            x = np.mod(x, 2 * span)
            out[:, d] = m + np.where(x > span, 2 * span - x, x)
        return out

    def get_frame(self, index: int) -> np.ndarray:
        if not 0 <= index < self.frame_count:
            raise IndexError(index)
        frame = self.plate.copy()
        h, w = frame.shape
        pos = self.positions(index)
        r = self.radius
        for cx, cy in pos:
            x0, x1 = max(0, int(cx - r - 1)), min(w, int(cx + r + 2))
            y0, y1 = max(0, int(cy - r - 1)), min(h, int(cy + r + 2))
            yy, xx = np.ogrid[y0:y1, x0:x1]
            blob = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            frame[y0:y1, x0:x1][blob] = self.fg_level
        return frame
