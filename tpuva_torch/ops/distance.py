"""Exact Euclidean distance transform — port of ``tpuva/ops/distance.py``
(scipy.ndimage.distance_transform_edt semantics: for every nonzero pixel,
the distance to the nearest zero pixel).

The squared EDT is separable. tpuva computes each 1D stage as iterated
3-point parabolic erosions: pass k updates
D <- min(D, shift(D, +1) + (2k-1), shift(D, -1) + (2k-1)). Since
sum_{k=1..d} (2k-1) = d^2, a pixel at distance d from its best seed holds
d^2 after d passes, and further passes never lower a converged value, so
running each axis to its fixed point gives the exact squared EDT: the
column stage each pixel's squared distance g to the nearest zero of its
column, the row stage the min-plus D(x) = min over x' of g(x') + (x-x')^2,
+inf where an axis holds no seed. ``edt_sq_passes_plain`` runs that loop
as torch ops, one host read a pass (its stop test), and is the plain
version of kernel KE.

On a CUDA tensor ``distance_transform_edt`` and ``_sq`` launch KE
(``edt_kernel``, csrc/distance.cu) once: the two stages computed directly
(a column's down and up scans; a row's outward search bounded by the best
so far), no host read. Both algorithms are exact while the squared
distances stay below 2^24, where float32 holds every integer: always when
(H - 1)^2 + (W - 1)^2 < 2^24 (a 1080p frame), so there they are bit-equal.
A pixel 4096 px or more from every zero (only on frames whose diagonal
passes 4096 px) gets KE's correctly rounded square, where the plain
loop's float32 sums may round on the way. KE refuses masks past 4096 px
a side. ``edt_model`` is KE's algorithm in numpy, the tests' model of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuva_torch import _build

_INF = float("inf")
# KE: the largest side (uint16 column distances, a row in shared memory)
EDT_MAX_SIDE = 4096
_NONE = 0xFFFF  # KE's column distance where the column has no zero that way
_INF_SQ = 0x7F000000  # KE's squared +inf (uint32)


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


def edt_sq_passes_plain(mask: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """KE's plain version: (the squared EDT of mask, the passes of the
    column and the row stage), tpuva's pass loops as torch ops."""
    d = torch.where(mask != 0, _INF, 0.0).to(torch.float32)
    d, cols = edt_pass_axis(d, mask.dim() - 2)  # columns: the 1D squared DT
    d, rows = edt_pass_axis(d, mask.dim() - 1)  # rows: the parabolic min-plus
    return d, (cols, rows)


def edt_kernel(mask: torch.Tensor, root: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """KE on a CUDA mask (..., H, W) of any dtype (nonzero = foreground):
    (the squared EDT, or with root its square root, float32; an int32[2]
    tensor on the card: the largest finite column distance and the largest
    smallest minimising row offset, each stage's passes less one). One
    launch (its two kernels); edt_kernel.launches counts them. Raises on
    another device, past EDT_MAX_SIDE a side, or on a CUDA error."""
    if mask.dim() < 2:
        raise ValueError("edt_kernel: mask must be (..., H, W)")
    if mask.device.type != "cuda":
        raise ValueError(f"edt_kernel: a CUDA tensor is needed, got {mask.device}")
    H, W = mask.shape[-2:]
    if H > EDT_MAX_SIDE or W > EDT_MAX_SIDE:
        raise ValueError(f"edt_kernel: {H} x {W} masks; KE takes at most "
                         f"{EDT_MAX_SIDE} px a side")
    m = mask.reshape((math.prod(mask.shape[:-2]), H, W))
    if m.dtype == torch.bool:
        m = m.view(torch.uint8)
    elif m.dtype != torch.uint8:
        m = (m != 0).view(torch.uint8)
    m = m.contiguous()
    out = torch.empty(m.shape, dtype=torch.float32, device=m.device)
    extents = torch.zeros(2, dtype=torch.int32, device=m.device)
    if m.numel() == 0:
        return out.reshape(mask.shape), extents
    if m.shape[0] > 65535:
        raise ValueError(f"edt_kernel: {m.shape[0]} masks; one launch takes 65535")
    cols = torch.empty(m.shape, dtype=torch.int16, device=m.device)  # uint16 bits
    _build.launch(m.device, "tpuva_edt", "edt kernel", m.data_ptr(), cols.data_ptr(),
                  out.data_ptr(), extents.data_ptr(), m.shape[0], H, W, int(root))
    edt_kernel.launches += 1
    return out.reshape(mask.shape), extents


edt_kernel.launches = 0


def edt_sq_passes(mask: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """(distance_transform_edt_sq(mask), the passes of the column and the
    row stage that tpuva's loop runs): on a CUDA tensor KE, whose extents
    give the passes (one host read); on a CPU one the plain loop."""
    if mask.device.type == "cpu":
        return edt_sq_passes_plain(mask)
    sq, extents = edt_kernel(mask, False)
    cols, rows = extents.tolist()
    return sq, (cols + 1, rows + 1)


def distance_transform_edt(mask: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance to the nearest zero pixel for every nonzero
    pixel of mask (..., H, W), any dtype; float32, 0 on the background,
    +inf everywhere for an image without a zero pixel. KE on a CUDA
    tensor; on a CPU one the plain loop, then the correctly rounded square
    root (as XLA's, scipy's and the card's): float64's, rounded to float32,
    since torch's float32 sqrt on the CPU is one ulp off at some squares
    (first at 1421 = 14^2 + 35^2 with its AVX512 kernels)."""
    if mask.device.type == "cpu":
        return torch.sqrt(edt_sq_passes_plain(mask)[0].double()).float()
    return edt_kernel(mask, True)[0]


def distance_transform_edt_sq(mask: torch.Tensor) -> torch.Tensor:
    """The squared exact EDT (exact integers in float32, no sqrt rounding)."""
    if mask.device.type == "cpu":
        return edt_sq_passes_plain(mask)[0]
    return edt_kernel(mask, False)[0]


def edt_model(mask) -> tuple[np.ndarray, tuple[int, int]]:
    """KE's algorithm in numpy, step for step: (the float32 squared EDT of
    mask (..., H, W), the passes that tpuva's loop runs). The column stage
    scans down then up with uint16 distances (_NONE without a zero that
    way); the row stage squares them into uint32 (_INF_SQ for none) and
    searches offsets j = 1, 2, ... on both sides, left before right, while
    j^2 is below the best so far, taking only strict improvements; a row
    without a finite g is +inf. The passes: 1 + the largest finite column
    distance, 1 + the largest offset of a finite output's last
    improvement."""
    m = np.asarray(mask) != 0
    shape = m.shape
    H, W = shape[-2:]
    m = m.reshape((-1, H, W))
    cols = np.empty(m.shape, np.int64)
    run = np.full((m.shape[0], W), _NONE, np.int64)
    for y in range(H):
        run = np.where(m[:, y], np.where(run == _NONE, _NONE, run + 1), 0)
        cols[:, y] = run
    run = np.full((m.shape[0], W), _NONE, np.int64)
    for y in range(H - 1, -1, -1):
        run = np.where(cols[:, y] == 0, 0, np.where(run == _NONE, _NONE, run + 1))
        cols[:, y] = np.minimum(cols[:, y], run)
    far = int(cols[cols != _NONE].max(initial=0))
    g = np.where(cols == _NONE, _INF_SQ, cols * cols)
    best = g.copy()
    at = np.zeros(g.shape, np.int64)
    active = (g < _INF_SQ).any(axis=-1, keepdims=True) & (best != 0)
    for j in range(1, W):
        active &= j * j < best
        if not active.any():
            break
        left = np.full(g.shape, 2 * _INF_SQ, np.int64)  # x - j < 0: no candidate
        left[..., j:] = g[..., :-j] + j * j
        right = np.full(g.shape, 2 * _INF_SQ, np.int64)
        right[..., :-j] = g[..., j:] + j * j
        for cand in (left, right):
            better = active & (cand < best)
            best = np.where(better, cand, best)
            at = np.where(better, j, at)
    finite = best < _INF_SQ
    sq = np.where(finite, best.astype(np.float32), np.float32(np.inf)).astype(np.float32)
    rows = int(at[finite].max(initial=0))
    return sq.reshape(shape), (far + 1, rows + 1)
