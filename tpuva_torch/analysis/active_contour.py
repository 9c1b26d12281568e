"""Greedy active contour ("snake") refining a polyline to image edges
(reference: video/analysis/active_contour.py, SURVEY.md §2.1).

Energy per point: alpha * tension (distance to neighbors' midpoint)
+ beta * stiffness (discrete curvature) - gamma * |image gradient|.
Greedy window search per point per iteration; the whole point set is
evaluated vectorized (points x window candidates) per iteration, so the
loop is over iterations only. Off the metric path — refines coarse masks
into smooth boundaries in the application layer.

The port's copy of ``tpuva/analysis/active_contour.py`` (numpy; cv2
imported in ``_edge_energy``), held to the original by
``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

import numpy as np

from tpuva_torch.analysis.image import bilinear_sample


class ActiveContour:
    def __init__(
        self,
        alpha: float = 0.1,
        beta: float = 0.2,
        gamma: float = 1.0,
        window: int = 2,
        max_iterations: int = 50,
        closed: bool = False,
        blur_radius: float = 2.0,
    ):
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.window = int(window)
        self.max_iterations = int(max_iterations)
        self.closed = closed
        self.blur_radius = blur_radius
        self.info: dict = {}

    # ------------------------------------------------------ external energy
    def _edge_energy(self, image: np.ndarray) -> np.ndarray:
        """Negative gradient magnitude of the blurred image (minimizing
        pulls points toward edges)."""
        import cv2

        img = np.asarray(image, np.float32)
        if self.blur_radius > 0:
            k = 2 * int(np.ceil(2 * self.blur_radius)) + 1
            img = cv2.GaussianBlur(img, (k, k), self.blur_radius)
        gx = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3)
        gy = cv2.Sobel(img, cv2.CV_32F, 0, 1, ksize=3)
        mag = np.hypot(gx, gy)
        peak = mag.max()
        return -(mag / peak) if peak > 0 else mag

    # --------------------------------------------------------------- fitting
    def fit(self, curve: np.ndarray, image: np.ndarray) -> np.ndarray:
        """Refine `curve` ((N, 2) of (x, y)) against `image`. Returns the
        refined curve; self.info reports iterations and convergence."""
        pts = np.asarray(curve, np.float64).copy()
        n = len(pts)
        if n < 3:
            self.info = {"iterations": 0, "converged": True}
            return pts
        E = self._edge_energy(image)
        w = self.window
        offs = np.array(
            [(dx, dy) for dy in range(-w, w + 1) for dx in range(-w, w + 1)],
            np.float64,
        )  # (K, 2)
        K = len(offs)
        moved_any = False
        for it in range(self.max_iterations):
            cand = pts[:, None, :] + offs[None, :, :]  # (N, K, 2)
            if self.closed:
                prev = np.roll(pts, 1, axis=0)
                nxt = np.roll(pts, -1, axis=0)
            else:
                prev = np.concatenate([pts[:1], pts[:-1]])
                nxt = np.concatenate([pts[1:], pts[-1:]])
            mid = (prev + nxt) / 2
            tension = np.linalg.norm(cand - mid[:, None, :], axis=2)
            curvature = np.linalg.norm(
                prev[:, None, :] - 2 * cand + nxt[:, None, :], axis=2
            )
            ext = bilinear_sample(
                E, cand[..., 0].reshape(-1), cand[..., 1].reshape(-1)
            ).reshape(n, K)
            energy = self.alpha * tension + self.beta * curvature + self.gamma * ext
            if not self.closed:
                # endpoints stay put (reference behavior for open snakes)
                center = K // 2
                energy[0, :] = np.inf
                energy[0, center] = -np.inf
                energy[-1, :] = np.inf
                energy[-1, center] = -np.inf
            best = np.argmin(energy, axis=1)
            new_pts = cand[np.arange(n), best]
            moved = np.abs(new_pts - pts).max()
            pts = new_pts
            if moved == 0:
                self.info = {"iterations": it + 1, "converged": True}
                return pts
            moved_any = True
        self.info = {"iterations": self.max_iterations, "converged": not moved_any}
        return pts
