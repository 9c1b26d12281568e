"""Connected components and per-blob stats — port of the stats contract of
``tpuva/ops/label.py``.

cv2 label-id semantics, as in the JAX package: 8-connectivity orders ids
by each component's first 2x2 block in block raster order (BBDT). Both
packages realise that order as the minimum of a scan key K per component
(``_scan_key``, a copy of the original), ranked ascending.

This module holds the plain pieces: ``label_components`` (iterated 3x3
neighbour-min over int32 keys until nothing changes — the plain version
kernel K2 is held against), ``component_sums`` (rank the roots, integer
``index_add`` of area, sum x, sum y), the stats epilogue
``_assemble_stats`` and ``extract_detections``. The kernel lives in
``ops/ccl.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def _scan_key(H: int, W: int, connectivity: int):
    """(kmap (H,W) int32, inv (S+1,) int32, S) — K bijection for the cv2
    scan order of the given connectivity, its inverse (K -> linear pixel
    index, with unused/sentinel K slots pointing at the pad slot S), and the
    sentinel value S (= one past the largest K). Copy of the original."""
    if connectivity == 4:
        S = H * W
        kmap = np.arange(S, dtype=np.int32).reshape(H, W)
    else:
        Hb, Wb = (H + 1) // 2, (W + 1) // 2
        r = np.arange(H)[:, None]
        c = np.arange(W)[None, :]
        kmap = (((r // 2) * Wb + (c // 2)) * 4 + (r % 2) * 2 + (c % 2)).astype(
            np.int32
        )
        S = Hb * Wb * 4
    inv = np.full(S + 1, H * W, np.int32)  # default: point at the pad slot
    inv[kmap.reshape(-1)] = np.arange(H * W, dtype=np.int32)
    return kmap, inv, S


def _neighbor_min_8(label: torch.Tensor, sent: int) -> torch.Tensor:
    """Min over the 3x3 neighbourhood (self included; outside = sent)."""
    H, W = label.shape[-2], label.shape[-1]
    lp = F.pad(label, (1, 1, 1, 1), value=sent)
    out = label
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                out = torch.minimum(out, lp[..., dy:dy + H, dx:dx + W])
    return out


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected root-key labels of an (N, H, W) mask, the convention of
    tpuva.ops.label.label_components: each component pixel holds its
    component's minimum scan key + 1, background 0."""
    H, W = mask.shape[-2:]
    kmap, _inv, S = _scan_key(H, W, 8)
    fg = mask != 0
    sent = torch.tensor(S, dtype=torch.int32, device=mask.device)
    lab = torch.where(fg, torch.from_numpy(kmap).to(mask.device), sent)
    while True:
        new = torch.where(fg, _neighbor_min_8(lab, S), sent)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(fg, lab + 1, 0)


def component_sums(root: torch.Tensor, max_components: int):
    """Per-component integer sums from root-key labels.

    root: (N, H, W) int32 as label_components returns it. Returns
    (count (N,) int32 = min(n_roots, C), sums (N, C, 3) int64 of
    (area, sum x, sum y) for the first C components in cv2 id order;
    later components are dropped, as _assemble_stats drops them)."""
    N, H, W = root.shape
    C = max_components
    dev = root.device
    kmap, _inv, S = _scan_key(H, W, 8)
    k = torch.from_numpy(kmap).to(dev)
    fg = root > 0
    is_root = fg & (root == k + 1)
    flags = torch.zeros((N, S), dtype=torch.int32, device=dev)
    flags[:, k.reshape(-1).long()] = is_root.reshape(N, -1).to(torch.int32)
    n_roots = flags.sum(1)
    rank_by_key = torch.cumsum(flags, 1, dtype=torch.int32) - flags
    key = (root - 1).clamp(min=0).reshape(N, -1).long()
    rank = torch.gather(rank_by_key, 1, key)
    n_idx, p_idx = (fg.reshape(N, -1) & (rank < C)).nonzero(as_tuple=True)
    vals = torch.stack(
        [torch.ones_like(p_idx), p_idx % W, p_idx // W], dim=1
    )
    sums = torch.zeros((N * C, 3), dtype=torch.int64, device=dev)
    sums.index_add_(0, n_idx * C + rank[n_idx, p_idx].long(), vals)
    count = torch.clamp(n_roots, max=C).to(torch.int32)
    return count, sums.reshape(N, C, 3)


def _assemble_stats(count: torch.Tensor, sums: torch.Tensor, H: int, W: int):
    """Stats epilogue of tpuva/ops/label.py::_assemble_stats on the integer
    sums: background row by subtraction from static image totals, float32
    centroid = float32 sum / float32 area, int32 centroid_sum.

    count: (N,) int32; sums: (N, C, 3) int64 (area, sum x, sum y).
    Returns the stats dict {count, area (N,C+1) int32, centroid
    (N,C+1,2) float32, centroid_sum (N,C+1,2) int32}."""
    dev = sums.device
    area_c = sums[..., 0].to(torch.int32)
    sx_c = sums[..., 1].to(torch.int32)
    sy_c = sums[..., 2].to(torch.int32)
    # int32 sums (wrapping, as jnp.sum of int32 does)
    area0 = (H * W - area_c.sum(1).to(torch.int32)).to(torch.int32)
    sx_tot = torch.tensor(np.float32(float(H) * (W - 1) * W / 2.0), device=dev)
    sy_tot = torch.tensor(np.float32(float(W) * (H - 1) * H / 2.0), device=dev)
    sx0 = sx_tot - sx_c.sum(1).to(torch.int32).to(torch.float32)
    sy0 = sy_tot - sy_c.sum(1).to(torch.int32).to(torch.float32)

    area = torch.cat([area0[:, None], area_c], dim=1)
    present = area > 0
    safe_area = torch.clamp(area, min=1).to(torch.float32)
    sx_f = torch.cat([sx0[:, None], sx_c.to(torch.float32)], dim=1)
    sy_f = torch.cat([sy0[:, None], sy_c.to(torch.float32)], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cx = torch.where(present, sx_f / safe_area, zero)
    cy = torch.where(present, sy_f / safe_area, zero)
    centroid = torch.stack([cx, cy], dim=-1)
    csum_c = torch.stack([sx_c, sy_c], dim=-1)
    # the background row's sums exceed int32 at large sizes: clamp the cast
    imax = float(np.float32(2**31 - 128))
    csum0 = torch.clamp(torch.stack([sx0, sy0], dim=-1), -imax, imax)
    csum = torch.cat([csum0.to(torch.int32)[:, None], csum_c], dim=1)
    csum = torch.where(present[:, :, None], csum, 0)
    return {
        "count": count.to(torch.int32),
        "area": area,
        "centroid": centroid,
        "centroid_sum": csum,
    }


def extract_detections(stats: dict, min_area: int, max_blobs: int = 8):
    """Area-filter components and pack the first `max_blobs` (in cv2 label
    order) into fixed slots — port of tpuva/ops/label.py::extract_detections.

    Returns (dets (N, max_blobs, 3) float32 of (x, y, area), n_det (N,)
    int32, valid (N, max_blobs) bool, det_sums (N, max_blobs, 2) int32 of
    exact integer coordinate sums). Slots are placed by one-term masked
    sums (exact: 0 + x == x)."""
    area = stats["area"][:, 1:]
    cent = stats["centroid"][:, 1:]
    csum = stats["centroid_sum"][:, 1:]
    count = stats["count"]
    N, C = area.shape
    dev = area.device
    comp_idx = torch.arange(C, dtype=torch.int32, device=dev)
    valid = (area >= min_area) & (comp_idx[None, :] < count[:, None])
    rank = torch.cumsum(valid.to(torch.int32), dim=1, dtype=torch.int32)
    slot = torch.where(valid & (rank <= max_blobs), rank - 1, max_blobs)
    payload = torch.cat([cent, area[..., None].to(torch.float32)], dim=-1)
    onehot = slot[:, None, :] == torch.arange(
        max_blobs, dtype=torch.int32, device=dev
    )[None, :, None]
    dets = torch.where(onehot[..., None], payload[:, None], 0.0).sum(2)
    det_sums = torch.where(onehot[..., None], csum[:, None], 0).sum(2).to(torch.int32)
    if C:
        n_det = torch.clamp(rank[:, -1], max=max_blobs).to(torch.int32)
    else:
        n_det = torch.zeros(N, dtype=torch.int32, device=dev)
    det_valid = torch.arange(max_blobs, device=dev)[None, :] < n_det[:, None]
    return dets, n_det, det_valid, det_sums
