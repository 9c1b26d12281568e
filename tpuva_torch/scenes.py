"""Synthetic (H, W) and (N, H, W) uint8 masks (0/255) that exercise the
CCL kernels' tile borders, ragged edges and component caps. The kernel
tests and ``chip_smoke.py`` hold the kernels against their plain versions
on them; numpy only.
"""

import numpy as np


def u_shape(H, W):
    """One component running right, down and back left across tiles."""
    m = np.zeros((H, W), np.uint8)
    m[10:14, 20:W - 10] = 255
    m[10:H - 10, W - 20:W - 10] = 255
    m[H - 20:H - 10, 30:W - 10] = 255
    return m


def mixed_scene():
    """One batch, one shape: random, empty, tile-straddling blobs, a U
    across tiles, and more components than C."""
    rng = np.random.default_rng(3)
    H, W = 130, 280
    m = np.zeros((5, H, W), np.uint8)
    m[0] = (rng.random((H, W)) < 0.25) * 255
    m[2, 60:70, 250:265] = 255  # crosses a 256-column border
    m[2, 62:66, 10:30] = 255
    m[2, 126:130, 0:8] = 255  # image edge, unaligned H
    m[2, 63:65, 120:200] = 255  # crosses a 64-row border
    m[3] = u_shape(H, W)
    m[4, 5:H:6, 5:W:7] = 255  # 21 x 40 isolated dots
    return m
