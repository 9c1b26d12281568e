"""Exact Euclidean distance transform — port of ``tpuva/ops/distance.py``
(scipy.ndimage.distance_transform_edt semantics: for every nonzero pixel,
the distance to the nearest zero pixel).

The squared EDT is separable. tpuva computes each 1D stage as iterated
3-point parabolic erosions: pass k updates
D <- min(D, shift(D, +1) + (2k-1), shift(D, -1) + (2k-1)). Since
sum_{k=1..d} (2k-1) = d^2, a pixel at distance d from its best seed holds
d^2 after d passes, and further passes never lower a converged value, so
running each axis to its fixed point gives the exact squared EDT while
the float32 sums stay below 2^24: the column stage each pixel's squared
distance g to the nearest zero of its column, the row stage the min-plus
D(x) = min over x' of g(x') + (x-x')^2, +inf where an axis holds no seed.
Past 2^24 the adds round (tpuva's own fault R6, ROADMAP Queue 3), and the
port keeps tpuva's values. ``edt_sq_passes_plain`` runs that loop
as torch ops, one host read a pass (its stop test), and is the plain
version of kernel KE.

On a CUDA tensor ``distance_transform_edt`` and ``_sq`` launch KE
(``edt_kernel``, csrc/distance.cu): the loop's float32 values at every
size, no host read. A column pass adds in float32 too, so a pixel d rows
from its column's nearest zero ends the column loop at f(d), the chained
float32 sum 1 + 3 + ... + (2d - 1) (``f_table``; d^2 up to 4096); the row
loop's fixed point is the minimum over x' of the same chain started at
g(x'), exact while it stays below 2^24. KE searches rows with exact sums,
and runs tpuva's row loop itself on a row where some pixel's minimum
reaches 2^24 (a pixel 4096 px or more from every zero). ``edt_model`` is
KE's algorithm in numpy, the tests' model of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuva_torch import _build

_INF = float("inf")
_EXACT = 1 << 24  # float32 holds every integer up to here
_EXACT_SIDE = 4096  # f(d) = d^2 up to here
MAX_MASKS_A_LAUNCH = 65535  # KE's grid y; edt_kernel splits more
_SHARED_ROW = 25600  # KE: wider rows live in global scratch (csrc/distance.cu kSharedRow)
_DEVICE_TABLES: dict = {}  # (H, device) -> f_table(H) on the card


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
    tensor on the card: the largest finite column distance and the last
    pass that lowered a finite row output, each stage's passes less one).
    One launch a MAX_MASKS_A_LAUNCH masks; edt_kernel.launches counts
    them. Where (H - 1)^2 + (W - 1)^2 >= 2^24 it also takes a list of the
    rows the row loop finishes, past 4097 rows the f table
    (``device_f_table``), and past _SHARED_ROW columns a float32 scratch
    of the masks' size. Raises on another device or on a CUDA error."""
    if mask.dim() < 2:
        raise ValueError("edt_kernel: mask must be (..., H, W)")
    if mask.device.type != "cuda":
        raise ValueError(f"edt_kernel: a CUDA tensor is needed, got {mask.device}")
    H, W = mask.shape[-2:]
    m = mask.reshape((math.prod(mask.shape[:-2]), H, W))
    if m.dtype == torch.bool:
        m = m.view(torch.uint8)
    elif m.dtype != torch.uint8:
        m = (m != 0).view(torch.uint8)
    m = m.contiguous()
    dev = m.device
    out = torch.empty(m.shape, dtype=torch.float32, device=dev)
    extents = torch.zeros(2, dtype=torch.int32, device=dev)
    if m.numel() == 0:
        return out.reshape(mask.shape), extents
    per = max(1, min(MAX_MASKS_A_LAUNCH, (2**31 - 2) // H))
    chunk = min(per, m.shape[0])
    large = (H - 1) ** 2 + (W - 1) ** 2 >= _EXACT
    ftab = device_f_table(H, dev) if H > _EXACT_SIDE + 1 else None
    scratch = (torch.empty((chunk, H, W), dtype=torch.float32, device=dev)
               if W > _SHARED_ROW else None)
    rows = torch.empty(1 + chunk * H, dtype=torch.int32, device=dev) if large else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    for i in range(0, m.shape[0], chunk):
        part = m[i:i + chunk]
        _build.launch(dev, "tpuva_edt", "edt kernel", part.data_ptr(), out[i:i + chunk].data_ptr(),
                      ptr(ftab), ptr(scratch), ptr(rows), extents.data_ptr(), part.shape[0], H,
                      W, int(root))
        edt_kernel.launches += 1
    return out.reshape(mask.shape), extents


edt_kernel.launches = 0


def device_f_table(H: int, device: torch.device) -> torch.Tensor:
    """f_table(H) on device, uploaded once a (height, device): KE's column
    values past 4096 rows."""
    key = (H, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = torch.from_numpy(f_table(H)).to(device)
    return _DEVICE_TABLES[key]


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


def f_table(n: int) -> np.ndarray:
    """f(d) for d < n, float32: where the column loop leaves a pixel d rows
    from its column's nearest zero. f(0) = 0, f(d) = fl(f(d - 1) + (2d - 1)):
    d^2 up to d = 4096, the chained float32 sum past it (KE's table)."""
    d = np.arange(n, dtype=np.int64)
    f = (d * d).astype(np.float32)
    if n > _EXACT_SIDE + 1:
        steps = np.concatenate([[np.float32(_EXACT)],
                                (2 * d[_EXACT_SIDE + 1:] - 1).astype(np.float32)])
        f[_EXACT_SIDE:] = np.add.accumulate(steps, dtype=np.float32)  # one add at a time
    return f


def edt_model(mask) -> tuple[np.ndarray, tuple[int, int]]:
    """KE's algorithm in numpy, step for step: (the float32 squared EDT of
    mask (..., H, W), the passes that tpuva's loop runs). Columns: each
    pixel's distance d to its column's nearest zero, then f(d) from
    ``f_table`` (+inf for none). Rows: a row without a finite value is
    +inf; otherwise every pixel searches offsets j = 1, 2, ... on both
    sides, left before right, while j^2 is below the best so far (which
    starts at min(f(d), 2^24)), taking strict improvements of the float32
    sum g(x') + j^2; a row where some pixel's best stays at 2^24 or more is
    flagged, and tpuva's row loop runs on it from its column values to its
    fixed point. The passes: 1 + the largest finite column distance; 1 +
    the largest offset of a finite output's last improvement, or the last
    pass that lowered a flagged row."""
    m = np.asarray(mask) != 0
    shape = m.shape
    H, W = shape[-2:]
    m = m.reshape((-1, H, W))
    none = np.iinfo(np.int64).max
    d = np.empty(m.shape, np.int64)
    run = np.full((m.shape[0], W), none, np.int64)
    for y in range(H):
        run = np.where(m[:, y], np.where(run == none, none, run + 1), 0)
        d[:, y] = run
    run = np.full((m.shape[0], W), none, np.int64)
    for y in range(H - 1, -1, -1):
        run = np.where(d[:, y] == 0, 0, np.where(run == none, none, run + 1))
        d[:, y] = np.minimum(d[:, y], run)
    finite_d = d != none
    far = int(d[finite_d].max(initial=0))
    g = np.full(m.shape, np.inf, np.float32)
    g[finite_d] = f_table(H)[d[finite_d]]
    any_row = np.isfinite(g).any(axis=-1, keepdims=True)
    best = np.minimum(g, np.float32(_EXACT))
    at = np.zeros(g.shape, np.int64)
    active = any_row & (g != 0)
    for j in range(1, W):
        jj = np.float32(j * j)
        active &= jj < best
        if not active.any():
            break
        left = np.full(g.shape, np.inf, np.float32)  # x - j < 0: no candidate
        left[..., j:] = g[..., :-j] + jj
        right = np.full(g.shape, np.inf, np.float32)
        right[..., :-j] = g[..., j:] + jj
        for cand in (left, right):
            better = active & (cand < best)
            best = np.where(better, cand, best)
            at = np.where(better, j, at)
    sq = np.where(any_row, np.where(g == 0, g, best), np.float32(np.inf)).astype(np.float32)
    rows = int(at[(sq < _EXACT) & any_row].max(initial=0))
    flagged = (any_row & (sq >= _EXACT)).any(axis=-1)
    if flagged.any():
        loop, last = row_loop(g[flagged])
        sq[flagged] = loop
        rows = max(rows, last)
    return sq.reshape(shape), (far + 1, rows + 1)


def row_loop(g: np.ndarray) -> tuple[np.ndarray, int]:
    """tpuva's row loop on rows g (n, W) float32, to their fixed point: pass
    k sets D(x) = min(D(x), D(x - 1) + (2k - 1), D(x + 1) + (2k - 1)), every
    add rounded to float32. (D, the last pass that lowered a value)."""
    d = g.copy()
    inf = np.full(d.shape[:-1] + (1,), np.inf, np.float32)
    k, last = 1, 0
    while True:
        w = np.float32(2 * k - 1)
        nd = np.minimum(d, np.minimum(np.concatenate([inf, d[..., :-1]], -1) + w,
                                      np.concatenate([d[..., 1:], inf], -1) + w))
        if np.array_equal(nd, d):
            return d, last
        d, last = nd, k
        k += 1
