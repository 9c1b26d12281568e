"""Connected components and per-blob stats — port of the stats contract of
``tpuva/ops/label.py``.

cv2 label-id semantics, as in the JAX package: 8-connectivity orders ids
by each component's first 2x2 block in block raster order (BBDT),
4-connectivity by its first pixel in raster order (SAUF). Both packages
realise that order as the minimum of a scan key K per component
(``_scan_key``, a copy of the original), ranked ascending.

This module holds the plain pieces: ``label_components`` (iterated 3x3 or
4-neighbour min over int32 keys until nothing changes — the plain version
kernels K2 and K3 are held against), the root table (``_root_table``: the
first C root keys per frame, ascending = cv2 id order), integer sums,
``root_stats_plain`` (the plain version of kernel K6), the stats epilogue
``_assemble_stats`` and ``_stats_dict``, and the entry points
``relabel_dense``, ``_stats_from_root``, ``connected_components_with_stats``
(K3, then K6 on a CUDA tensor) and ``extract_detections``. The kernels
live in ``ops/ccl.py``.

tpuva contracts bf16 6-bit limbs of a (N, H*W, C) one-hot on the MXU; the
plain version finds each foreground pixel's component by a sorted search
in the root table and takes exact integer ``index_add_`` /
``scatter_reduce_`` (amin/amax for the bbox) over those pixels only;
kernel K6 takes integer atomics keyed by the same table: deterministic,
and no (N, H*W, C) tensor, which would not fit at 1080p and batch 256.
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


@lru_cache(maxsize=8)
def _kmap_on(H: int, W: int, connectivity: int, device: torch.device) -> torch.Tensor:
    """_scan_key's kmap as an (H, W) int32 tensor on `device`, copied there
    once per shape (read only)."""
    return torch.from_numpy(_scan_key(H, W, connectivity)[0]).to(device)


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


def _neighbor_min_4(label: torch.Tensor, sent: int) -> torch.Tensor:
    """Min over self and the 4 edge neighbours (outside = sent)."""
    H, W = label.shape[-2], label.shape[-1]
    lp = F.pad(label, (1, 1, 1, 1), value=sent)
    out = label
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        out = torch.minimum(out, lp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return out


def _segmented_min_scan(v: torch.Tensor, mask: torch.Tensor, axis: int, sent=None,
                        reverse: bool = False) -> torch.Tensor:
    """Segmented running minimum along `axis` — tpuva's _segmented_min_scan
    (prefix doubling there): each mask pixel takes the minimum of v over
    its contiguous mask run from the run's start (its end, reversed) up to
    itself; pixels off the mask keep v and block propagation. v int32;
    sent, tpuva's fill, changes nothing here.

    One torch.cummin over int64 keys: a run's number, counted from the far
    end, in the high word, v + 2^31 in the low one, off-mask pixels the
    largest key. A pixel's earlier runs have larger numbers, so the running
    minimum at a mask pixel is the minimum of its own run so far."""
    if reverse:
        v, mask = v.flip(axis), mask.flip(axis)
    n = v.shape[axis]
    prev = mask.narrow(axis, 0, n - 1)
    start = mask.clone()
    start.narrow(axis, 1, n - 1).logical_and_(~prev)
    run = torch.cumsum(start, axis, dtype=torch.int32)
    key = torch.where(mask, ((n - run).long() << 32) | (v.long() + 2**31),
                      torch.iinfo(torch.int64).max)
    del run, start
    low = (torch.cummin(key, axis).values & 0xFFFFFFFF) - 2**31
    out = torch.where(mask, low.to(torch.int32), v)
    return out.flip(axis) if reverse else out


def _check_connectivity(connectivity: int) -> None:
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")


def label_components(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Root-key labels of an (N, H, W) or (H, W) mask, the convention of
    tpuva.ops.label.label_components: each component pixel holds its
    component's minimum scan key + 1, background 0."""
    _check_connectivity(connectivity)
    H, W = mask.shape[-2:]
    S = _scan_key(H, W, connectivity)[2]
    nb_min = _neighbor_min_8 if connectivity == 8 else _neighbor_min_4
    fg = mask != 0
    sent = torch.tensor(S, dtype=torch.int32, device=mask.device)
    lab = torch.where(fg, _kmap_on(H, W, connectivity, mask.device), sent)
    while True:
        new = torch.where(fg, nb_min(lab, S), sent)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(fg, lab + 1, 0)


def _root_table(root: torch.Tensor, connectivity: int, max_components: int):
    """The first `max_components` root keys of each frame in cv2 id order.

    root: (N, H, W) int32 root-key labels. Returns (table (N, C) int32 of
    root-label values K + 1, ascending, the sentinel S + 2 where absent, as
    tpuva's _root_table; n_roots (N,) int32, the uncapped component
    count). A root is a pixel whose label is its own key + 1; the roots are
    few, so they are ranked by one sort of (frame, key)."""
    N, H, W = root.shape
    C = max_components
    dev = root.device
    S = _scan_key(H, W, connectivity)[2]
    k = _kmap_on(H, W, connectivity, dev)
    is_root = (root > 0) & (root == k + 1)
    n_idx, p_idx = is_root.reshape(N, -1).nonzero(as_tuple=True)
    keys = k.reshape(-1)[p_idx].long()
    order = torch.argsort(n_idx * (S + 1) + keys)
    n_sorted, key_sorted = n_idx[order], keys[order]
    n_roots = torch.bincount(n_idx, minlength=N)
    first = torch.cumsum(n_roots, 0) - n_roots
    rank = torch.arange(n_sorted.numel(), device=dev) - first[n_sorted]
    sel = rank < C
    table = torch.full((N, C), S + 2, dtype=torch.int32, device=dev)
    table[n_sorted[sel], rank[sel]] = (key_sorted[sel] + 1).to(torch.int32)
    return table, n_roots.to(torch.int32)


def _component_pixels(root: torch.Tensor, connectivity: int, max_components: int):
    """Foreground pixels of each frame's first C components in cv2 id order.

    Returns (count (N,) int32 = min(n_roots, C), n_idx, p_idx, rank), the
    last three (M,) int64 — frame, raster index and cv2 id - 1; pixels of
    later components are left out. One sorted search of (frame, label) in
    the root table, whose rows are ascending and whose sentinel exceeds
    every label."""
    table, n_roots = _root_table(root, connectivity, max_components)
    count = torch.clamp(n_roots, max=max_components).to(torch.int32)
    N, C = table.shape
    flat_root = root.reshape(N, -1)
    n_idx, p_idx = (flat_root > 0).nonzero(as_tuple=True)
    stride = 1 << 32  # above every label and the sentinel: frames stay sorted
    frame_base = torch.arange(N, device=root.device)[:, None] * stride
    flat_table = (table.long() + frame_base).reshape(-1)
    q = flat_root[n_idx, p_idx].long() + n_idx * stride
    pos = torch.searchsorted(flat_table, q).clamp(max=N * C - 1)
    hit = flat_table[pos] == q
    return count, n_idx[hit], p_idx[hit], (pos - n_idx * C)[hit]


def _pixel_sums(shape, C: int, n_idx, p_idx, rank) -> torch.Tensor:
    """(N, C, 3) int64 sums of (area, x, y) over _component_pixels."""
    N, _H, W = shape
    vals = torch.stack([torch.ones_like(p_idx), p_idx % W, p_idx // W], dim=1)
    sums = torch.zeros((N * C, 3), dtype=torch.int64, device=p_idx.device)
    sums.index_add_(0, n_idx * C + rank, vals)
    return sums.reshape(N, C, 3)


def component_sums(root: torch.Tensor, max_components: int, connectivity: int = 8):
    """Per-component integer sums from root-key labels.

    root: (N, H, W) int32 as label_components returns it. Returns
    (count (N,) int32 = min(n_roots, C), sums (N, C, 3) int64 of
    (area, sum x, sum y) for the first C components in cv2 id order;
    later components are dropped, as _assemble_stats drops them)."""
    count, n_idx, p_idx, rank = _component_pixels(root, connectivity, max_components)
    return count, _pixel_sums(root.shape, max_components, n_idx, p_idx, rank)


def root_stats_plain(root: torch.Tensor, max_components: int, connectivity: int = 8,
                     sums: bool = True, bbox: bool = False, labels: bool = False):
    """Plain version of kernel K6 (ops.ccl.root_stats), the torch ops: a
    root compare, a sort of the roots, nonzero, searchsorted, index_add_
    and scatter_reduce_. Any device (CPU tensors reach it through
    root_stats; chip_smoke.py runs it on the card as K6's yardstick).

    Returns (count (N,) int32, sums (N, C, 3) int64, lohi (N, C, 4) int32
    of (min x, min y, max x, max y), 2^30 / -1 where absent, dense
    (N, H, W) int32 ids), an output not asked for None."""
    N, H, W = root.shape
    C = max_components
    dev = root.device
    count, n_idx, p_idx, rank = _component_pixels(root, connectivity, C)
    out_sums = _pixel_sums(root.shape, C, n_idx, p_idx, rank) if sums else None
    lohi = dense = None
    if bbox:
        xy = torch.stack([p_idx % W, p_idx // W], dim=1)
        idx = (n_idx * C + rank)[:, None].expand(-1, 2)
        lo = torch.full((N * C, 2), 2**30, dtype=torch.int64, device=dev)
        hi = torch.full((N * C, 2), -1, dtype=torch.int64, device=dev)
        lo.scatter_reduce_(0, idx, xy, "amin")
        hi.scatter_reduce_(0, idx, xy, "amax")
        lohi = torch.cat([lo, hi], dim=1).reshape(N, C, 4).to(torch.int32)
    if labels:
        dense = torch.zeros((N, H * W), dtype=torch.int32, device=dev)
        dense[n_idx, p_idx] = (rank + 1).to(torch.int32)
        dense = dense.reshape(N, H, W)
    return count, out_sums, lohi, dense


def relabel_dense(root_label: torch.Tensor, max_components: int = 64,
                  connectivity: int = 8, strip_occ=None):
    """Root-key labels (from label_components) to cv2's dense scan-order
    ids 1..n, 0 background, components past max_components -> 0 — port of
    tpuva.ops.label.relabel_dense. (N, H, W) or (H, W) int32.

    Kernel K6 (ops.ccl.root_stats, labels only) on a CUDA tensor, given
    strip_occ (K3's, ops.ccl.root_labels) or deriving it; its plain
    version on a CPU tensor. Returns (dense (N, H, W) int32, count (N,)
    int32 = min(n, C))."""
    from tpuva_torch.ops.ccl import root_stats

    squeeze = root_label.dim() == 2
    root = root_label[None] if squeeze else root_label
    if squeeze and strip_occ is not None:
        strip_occ = strip_occ[None]
    count, _sums, _lohi, dense = root_stats(root, max_components, connectivity, sums=False,
                                            labels=True, strip_occ=strip_occ)
    return (dense[0], count[0]) if squeeze else (dense, count)


def _assemble_stats(count: torch.Tensor, sums: torch.Tensor, H: int, W: int):
    """Stats epilogue of tpuva/ops/label.py::_assemble_stats on the integer
    sums: background row by subtraction from static image totals, float32
    centroid = float32 sum / float32 area, int32 centroid_sum. The three
    columns go through each op together: about 20 torch ops a call. On the
    card K2 and K6 compute it in their kernels (csrc/ccl.cu
    stats_epilogue), held to this bit for bit.

    count: (N,) int32; sums: (N, C, 3) int64 (area, sum x, sum y).
    Returns the stats dict {count, area (N,C+1) int32, centroid
    (N,C+1,2) float32, centroid_sum (N,C+1,2) int32}."""
    N = sums.shape[0]
    s32 = sums.to(torch.int32)
    # int32 sums (wrapping, as jnp.sum of int32 does)
    tot = s32.sum(1).to(torch.int32)
    area0 = H * W - tot[:, 0]
    # the image totals of x and y, filled on the device: a tensor made from
    # a host value on the card would be a copy that waits for the stream
    xy0 = torch.full((N, 2), float(np.float32(float(H) * (W - 1) * W / 2.0)),
                     dtype=torch.float32, device=sums.device)
    xy0[:, 1] = float(np.float32(float(W) * (H - 1) * H / 2.0))
    xy0 -= tot[:, 1:].to(torch.float32)

    area = torch.cat([area0[:, None], s32[..., 0]], dim=1)
    present = area > 0
    safe_area = torch.clamp(area, min=1).to(torch.float32)
    xy = torch.cat([xy0[:, None], s32[..., 1:].to(torch.float32)], dim=1)
    centroid = torch.where(present[..., None], xy / safe_area[..., None], 0.0)
    # the background row's sums exceed int32 at large sizes: clamp the cast
    imax = float(np.float32(2**31 - 128))
    csum0 = torch.clamp(xy0, -imax, imax).to(torch.int32)
    csum = torch.cat([csum0[:, None], s32[..., 1:]], dim=1)
    csum = torch.where(present[..., None], csum, 0)
    return {
        "count": count.to(torch.int32),
        "area": area,
        "centroid": centroid,
        "centroid_sum": csum,
    }


def _stats_dict(count, sums, lohi, dense, H: int, W: int) -> dict:
    """The stats dict of _stats_from_root from the outputs of K6's plain
    version: _assemble_stats, then the bbox (x, y, w, h) from the extremes,
    the labels (a broadcast zero where dense is None), overflow. Kernel K6
    computes the same dict on the card (csrc/ccl.cu stats_epilogue)."""
    N, C = sums.shape[:2]
    dev = sums.device
    out = _assemble_stats(count, sums, H, W)
    present = out["area"] > 0
    if dense is None:  # a broadcast zero: nothing is allocated or written
        dense = torch.zeros((), dtype=torch.int32, device=dev).expand(N, H, W)
    bbox = torch.zeros((N, C + 1, 4), dtype=torch.int32, device=dev)
    if lohi is not None:
        lo, hi = lohi[..., :2].long(), lohi[..., 2:].long()
        # background row: the full image, as tpuva's (its reference scenes
        # always have background at the image borders)
        bbox0 = torch.zeros((N, 1, 4), dtype=torch.int64, device=dev)
        bbox0[..., 2], bbox0[..., 3] = W, H
        bbox = torch.cat([bbox0, torch.cat([lo, hi - lo + 1], dim=2)], dim=1)
        bbox = torch.where(present[:, :, None], bbox, 0).to(torch.int32)
    out["labels"] = dense
    out["bbox"] = bbox
    out["overflow"] = torch.zeros((N,), dtype=torch.int32, device=dev)
    return out


def _stats_from_root(root: torch.Tensor, max_components: int = 64,
                     connectivity: int = 8, compute_bbox: bool = True,
                     compute_labels: bool = True, strip_occ=None) -> dict:
    """Stats of root-key labels (N, H, W) int32 — the dense branch of
    tpuva.ops.label._stats_from_root; see connected_components_with_stats
    for the output contract. Kernel K6 (ops.ccl.root_stats_dict, one
    launch that writes the whole dict) on a CUDA tensor, given strip_occ
    (K3's) or deriving it; its plain version on a CPU tensor."""
    from tpuva_torch.ops.ccl import root_stats_dict

    return root_stats_dict(root, max_components, connectivity, compute_bbox, compute_labels,
                           strip_occ)


def _stats_from_root_plain(root: torch.Tensor, max_components: int = 64,
                           connectivity: int = 8, compute_bbox: bool = True,
                           compute_labels: bool = True) -> dict:
    """_stats_from_root through K6's plain version (the torch ops) on any
    device: the yardstick chip_smoke.py times and checks K6 against."""
    H, W = root.shape[1:]
    return _stats_dict(*root_stats_plain(root, max_components, connectivity, True, compute_bbox,
                                         compute_labels), H, W)


def connected_components_with_stats(
    mask: torch.Tensor,
    max_components: int = 64,
    connectivity: int = 8,
    compute_bbox: bool = True,
    compute_labels: bool = True,
    strict: bool = True,
) -> dict:
    """Batched cv2.connectedComponentsWithStats — port of
    tpuva.ops.label.connected_components_with_stats.

    mask: (N, H, W) or (H, W) uint8/bool. Returns a dict of
      labels       (N, H, W) int32 — dense cv2-order ids, 0 = background
                   (when compute_labels=False, a read-only broadcast zero)
      count        (N,) int32 — components, capped at C
      area         (N, C+1) int32 — row 0 the background, rows 1..C blobs
      bbox         (N, C+1, 4) int32 — (x, y, w, h), zeros for absent ids
                   (all zeros when compute_bbox=False)
      centroid     (N, C+1, 2) float32 — (x, y), (0, 0) for absent ids
      centroid_sum (N, C+1, 2) int32 — exact coordinate sums
      overflow     (N,) int32 — zeros (no capacity but C)
      ccl_converged bool
    C = max_components. On a CUDA tensor kernel K3 (ops.ccl.root_labels)
    gives the root-key labels and its strip occupancy, and kernel K6
    (ops.ccl.root_stats_dict, one launch) the stats dict from them,
    reading only that occupancy's strips; on a CPU tensor their plain
    versions. Union-find has no round cap, so ccl_converged is always True
    and strict (raise if not converged, as tpuva) never fires."""
    from tpuva_torch.ops.ccl import root_labels

    squeeze = mask.dim() == 2
    if squeeze:
        mask = mask[None]
    root, occ = root_labels(mask, connectivity)
    out = _stats_from_root(root, max_components, connectivity, compute_bbox, compute_labels,
                           strip_occ=occ)
    out["ccl_converged"] = True
    if squeeze:
        out = {k: v if k == "ccl_converged" else v[0] for k, v in out.items()}
    return out


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
