"""Exact Euclidean distance transform — port of ``tpuva/ops/distance.py``
(scipy.ndimage.distance_transform_edt semantics: for every nonzero pixel,
the distance to the nearest zero pixel).

The squared EDT is separable, and each 1D stage is computed as iterated
3-point parabolic erosions: pass k updates
D <- min(D, shift(D, +1) + (2k-1), shift(D, -1) + (2k-1)). Since
sum_{k=1..d} (2k-1) = d^2, a pixel at distance d from its best seed holds
d^2 after d passes, and further passes never lower a converged value, so
running each axis to its fixed point gives the exact squared EDT: integers
below 2^24 for images up to 4096 px a side, exact in float32, +inf where
an axis holds no seed. Torch ops on the mask's device; the loop's stop
test (any pixel changed) is one read on the host a pass, which is why
tpuva calls this an analysis utility, off the metric path.
"""

from __future__ import annotations

import torch

_INF = float("inf")


def _shift(x: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """x shifted by one pixel along dim (s = +1: out[i] = x[i - 1]), +inf
    flowing in at the border."""
    n = x.shape[dim]
    edge = torch.full_like(x.narrow(dim, 0, 1), _INF)
    if s > 0:
        return torch.cat([edge, x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), edge], dim)


def edt_pass_axis(d: torch.Tensor, dim: int) -> tuple[torch.Tensor, int]:
    """One axis's parabolic erosion run to its fixed point: (d, passes),
    d (..., H, W) float32 squared distances (0 at seeds, +inf unseeded);
    passes counts the erosions, the last of which changed nothing."""
    k = 1
    while True:
        w = 2.0 * k - 1.0
        nd = torch.minimum(d, torch.minimum(_shift(d, 1, dim) + w, _shift(d, -1, dim) + w))
        changed = not torch.equal(nd, d)
        d = nd
        if not changed:
            return d, k
        k += 1


def edt_sq_passes(mask: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """(distance_transform_edt_sq(mask), the passes of the column and the
    row stage)."""
    d = torch.where(mask != 0, _INF, 0.0).to(torch.float32)
    d, cols = edt_pass_axis(d, mask.dim() - 2)  # columns: the 1D squared DT
    d, rows = edt_pass_axis(d, mask.dim() - 1)  # rows: the parabolic min-plus
    return d, (cols, rows)


def distance_transform_edt(mask: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance to the nearest zero pixel for every nonzero
    pixel of mask (..., H, W), any dtype; float32, 0 on the background,
    +inf everywhere for an image without a zero pixel."""
    return torch.sqrt(edt_sq_passes(mask)[0])


def distance_transform_edt_sq(mask: torch.Tensor) -> torch.Tensor:
    """The squared exact EDT (exact integers in float32, no sqrt rounding)."""
    return edt_sq_passes(mask)[0]
