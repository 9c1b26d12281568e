"""The band path's CCL — kernels KB — and their plain versions.

tpuva's spatial processor (``tpuva/dist/spatial.py``) labels each row band
of a frame on the image's global 8-connected block-raster scan keys,
reconciles the bands' edges to a fixed point and contracts each band's
pixels against a table of its pieces' values. Its XLA stages and their
kernels here:

- ``band_sweep`` (:191), the band labels: KB-labels, ``band_labels``
  (``csrc/ccl.cu::tpuva_band_labels``, K3's 2x2-block union-find on the
  band, labels written as global keys; a band whose first row is odd is
  labelled as a frame with one blank row above it, so that its blocks are
  the image's). Plain version ``band_labels_plain``: tpuva's sweep, the
  8-neighbour min and four segmented min-scans to a fixed point.
- ``recon_body`` (:229), a reconciliation round: KB-recon, ``recon_edges``
  then ``recon_min`` (``csrc/spatial.cu``) on every band.
- the piece table (:286-294) and its sums (:295-312): KB-table,
  ``piece_table`` and ``piece_sums`` (``csrc/spatial.cu``).

The piece form (``BandPieces``). After the band labels each band piece
holds its minimum global key on every pixel, and the reconciliation only
lowers whole pieces, so a piece's value lives once, at its root block
(the 2x2 block of its minimum key): ``val[n, (label - kbase) >> 2]``. A
round snapshots every band's two edge rows as their values
(``recon_edges``), then lowers each piece by the neighbour bands'
snapshots (``recon_min``): all snapshots before any minimum, tpuva's
Jacobi round, so ``tp_recon_rounds`` is tpuva's.

CUDA tensors launch the kernels and CPU tensors take the plain versions;
there is no fallback. Each wrapper counts its launches (``.launches``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpuva_torch import _build
from tpuva_torch.ops.label import _neighbor_min_8, _pixel_sums, _segmented_min_scan

# pixels of frames band_labels_plain sweeps at once: its int64 scan keys
# stay ~256 MB (the plain version runs on the card too, as KB-labels'
# yardstick at 1080p)
SWEEP_PX = 1 << 25
STRIP_BLOCKS = 128  # K3's strips: one 2x2-block row x 128 blocks


class BandPieces(NamedTuple):
    """One band's labels in the piece form.

    lab (N, Hb, W) int32: each foreground pixel its band piece's minimum
    global scan key, background sent (tpuva's band_sweep fixed point).
    val (N, nblk) int32: at each piece's root block the piece's value (its
    key, lowered by the reconciliation); other entries undefined.
    roots (N, nblk) int32: each frame's root blocks, the first nroots[n]
    (ascending from the plain version, in no order from the kernel).
    nroots (N,) int32: the band's pieces a frame (tpuva's n_loc).
    occ: KB-labels' strip occupancy (N, Hbk, S) uint8 on the card, None on
    the CPU. flag (1,) int32: whether the last round changed a piece.
    y0: the band's first row in the image; r0 = y0 & 1; kbase: the global
    key of the band's block 0; sent: the background label."""
    lab: torch.Tensor
    val: torch.Tensor
    roots: torch.Tensor
    nroots: torch.Tensor
    occ: Optional[torch.Tensor]
    flag: torch.Tensor
    y0: int
    r0: int
    kbase: int
    sent: int


def band_geometry(Hb: int, W: int, y0: int) -> tuple:
    """(r0, kbase, nblk) of a band of Hb rows from image row y0: its first
    row's parity, the global key of its first block and its blocks a frame
    (the blocks of an (Hb + r0, W) frame)."""
    r0, Wb = y0 & 1, (W + 1) // 2
    return r0, 2 * (y0 - r0) * Wb, ((Hb + r0 + 1) // 2) * Wb


def band_keys(y0: int, Hb: int, W: int, device=None) -> torch.Tensor:
    """(Hb, W) int32 global 8-connected scan keys of image rows y0 ..
    y0 + Hb - 1 (tpuva's _scan_key, ((r >> 1) * Wb + (c >> 1)) * 4 +
    (r & 1) * 2 + (c & 1))."""
    Wb = (W + 1) // 2
    rr = torch.arange(Hb, dtype=torch.int32, device=device)[:, None] + y0
    cc = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    return ((rr >> 1) * Wb + (cc >> 1)) * 4 + (rr & 1) * 2 + (cc & 1)


def _sweep(label: torch.Tensor, m: torch.Tensor, sent: int) -> torch.Tensor:
    """One sweep: the 8-neighbour min, then the four segmented min-scans."""
    label = torch.where(m, torch.minimum(label, _neighbor_min_8(label, sent)), sent)
    label = _segmented_min_scan(label, m, 2, sent)
    label = _segmented_min_scan(label, m, 2, sent, reverse=True)
    label = _segmented_min_scan(label, m, 1, sent)
    return _segmented_min_scan(label, m, 1, sent, reverse=True)


def _band_sweep(lab: torch.Tensor, m: torch.Tensor, sent: int) -> None:
    """tpuva's band_sweep: the band's labels (N, Hb, W) int32 swept in place
    to their fixed point, SWEEP_PX pixels of frames at a time (frames are
    independent, so each reaches the fixed point tpuva's whole-band loop
    gives it; the chunks bound the int64 keys of _segmented_min_scan)."""
    N, Hb, W = lab.shape
    step = max(1, SWEEP_PX // max(1, Hb * W))
    for s in range(0, N, step):
        cur, mc = lab[s:s + step], m[s:s + step]
        while True:
            new = _sweep(cur, mc, sent)
            if torch.equal(new, cur):
                break
            cur = new
        lab[s:s + step] = cur


def band_labels_plain(mask: torch.Tensor, y0: int, sent: int) -> BandPieces:
    """Plain version of KB-labels on the band mask (N, Hb, W) (nonzero =
    foreground) whose first row is image row y0: tpuva's band_sweep from
    lab0 (each foreground pixel its own global key), then the piece form
    (roots: the pixels whose label is their own key)."""
    m = mask != 0
    N, Hb, W = m.shape
    r0, kbase, nblk = band_geometry(Hb, W, y0)
    kv = band_keys(y0, Hb, W, m.device)
    lab = torch.where(m, kv, sent)
    _band_sweep(lab, m, sent)
    n_i, p_i = (m & (lab == kv)).reshape(N, -1).nonzero(as_tuple=True)
    b_i = ((kv.reshape(-1)[p_i] - kbase) >> 2).long()
    val = torch.full((N, nblk), sent, dtype=torch.int32, device=m.device)
    val[n_i, b_i] = lab.reshape(N, -1)[n_i, p_i]
    is_root = torch.zeros((N, nblk), dtype=torch.bool, device=m.device)
    is_root[n_i, b_i] = True
    nroots = is_root.sum(1, dtype=torch.int32)
    blocks = torch.arange(nblk, dtype=torch.int32, device=m.device)
    roots = torch.where(is_root, blocks, nblk).sort(dim=1).values
    roots = torch.where(blocks < nroots[:, None], roots, 0)
    return BandPieces(lab, val, roots, nroots, None,
                      torch.zeros((1,), dtype=torch.int32, device=m.device),
                      y0, r0, kbase, sent)


def band_labels(mask: torch.Tensor, row0: int, rows: int, y0: int, sent: int) -> BandPieces:
    """KB-labels: the band rows row0 .. row0 + rows - 1 of mask (N, Hm, W)
    uint8/bool (nonzero = foreground; e.g. a band's front-end mask with its
    halo rows), image rows y0 .. y0 + rows - 1, labelled on global scan
    keys; sent: the image's sentinel key (one past its largest). Returns
    its BandPieces. CUDA tensors make one launch sequence of
    tpuva_band_labels (csrc/ccl.cu), reading the band in place; CPU
    tensors take band_labels_plain."""
    if mask.dim() != 3 or mask.dtype not in (torch.uint8, torch.bool):
        raise ValueError("band_labels: mask must be (N, H, W) uint8 or bool")
    N, Hm, W = mask.shape
    if not (0 <= row0 and rows >= 1 and row0 + rows <= Hm) or N < 1 or y0 < 0:
        raise ValueError(f"band_labels: rows {row0}..{row0 + rows} of a {Hm}-row mask, N={N}")
    if sent + 2 >= 1 << 31:
        raise ValueError("band_labels: scan keys must stay below 2^31 - 2")
    if mask.device.type == "cpu":
        return band_labels_plain(mask[:, row0:row0 + rows], y0, sent)
    if mask.device.type != "cuda":
        raise ValueError(f"band_labels: unsupported device {mask.device}")
    if N >= 1 << 16:
        raise ValueError("band_labels kernel: N < 65536")
    return _band_labels_cuda(mask.to(torch.uint8).contiguous(), row0, rows, y0, sent)


def _band_labels_cuda(mask: torch.Tensor, row0: int, rows: int, y0: int, sent: int):
    """The launch sequence of tpuva_band_labels on a contiguous uint8 mask."""
    N, Hm, W = mask.shape
    dev = mask.device
    r0, kbase, nblk = band_geometry(rows, W, y0)
    Hbk, Wb = (rows + r0 + 1) // 2, (W + 1) // 2
    i32 = dict(dtype=torch.int32, device=dev)
    lab = torch.empty((N, rows, W), **i32)
    val = torch.empty((N, nblk), **i32)
    roots = torch.empty((N, nblk), **i32)
    nroots = torch.empty((N,), **i32)
    occ = torch.empty((N, Hbk, -(-Wb // STRIP_BLOCKS)), dtype=torch.uint8, device=dev)
    tiles = torch.empty((N, -(-Hbk // 16) * -(-Wb // 32)), **i32)
    ntiles = torch.empty((N,), **i32)
    parent = torch.empty((N, nblk), **i32)
    bits = torch.empty((N, nblk), dtype=torch.uint8, device=dev)
    _build.launch(
        dev, "tpuva_band_labels", "band labels kernel",
        mask.data_ptr() + row0 * W, Hm * W, N, rows, W, r0, kbase, sent, occ.data_ptr(),
        tiles.data_ptr(), ntiles.data_ptr(), parent.data_ptr(), bits.data_ptr(), lab.data_ptr(),
        val.data_ptr(), roots.data_ptr(), nroots.data_ptr(),
    )
    band_labels.launches += 1
    return BandPieces(lab, val, roots, nroots, occ, torch.empty((1,), **i32), y0, r0, kbase,
                      sent)


band_labels.launches = 0  # every KB-labels launch sequence


def _band_args(p: BandPieces) -> tuple:
    N, Hb, W = p.lab.shape
    return N, Hb, W, p.r0, p.y0, p.kbase, p.sent


def _values(p: BandPieces, labels: torch.Tensor) -> torch.Tensor:
    """The piece values of labels (foreground labels of p; any shape)."""
    N = p.lab.shape[0]
    blk = ((labels - p.kbase) >> 2).long().reshape(N, -1)
    return p.val.gather(1, blk).reshape(labels.shape)


def recon_edges_plain(p: BandPieces) -> torch.Tensor:
    """Plain version of recon_edges: (N, 2, W) int32, the band's rows 0 and
    Hb - 1 as their pieces' values, background sent; p.flag zeroed."""
    e = p.lab[:, [0, -1]]
    fg = e != p.sent
    p.flag.zero_()
    return torch.where(fg, _values(p, torch.where(fg, e, p.kbase)), p.sent)


def recon_edges(p: BandPieces) -> torch.Tensor:
    """KB-recon's snapshot: the band's edge rows as their values now, (N, 2,
    W) int32, and p.flag zeroed. Every band's snapshot of a round is taken
    before any band's recon_min. CUDA: one launch of tpuva_kb_edges."""
    if p.lab.device.type == "cpu":
        return recon_edges_plain(p)
    return _recon_edges_cuda(p)


def _recon_edges_cuda(p: BandPieces) -> torch.Tensor:
    N, _Hb, W = p.lab.shape
    edges = torch.empty((N, 2, W), dtype=torch.int32, device=p.lab.device)
    _build.launch(p.lab.device, "tpuva_kb_edges", "recon edges kernel", p.lab.data_ptr(),
                  p.val.data_ptr(), *_band_args(p), edges.data_ptr(), p.flag.data_ptr())
    recon_edges.launches += 1
    return edges


recon_edges.launches = 0


def _adj(nb: torch.Tensor, sent: int) -> torch.Tensor:
    """8-connected partners of an edge row (N, W): itself and its left and
    right neighbours, sent outside."""
    p = F.pad(nb, (1, 1), value=sent)
    return torch.minimum(nb, torch.minimum(p[:, :-2], p[:, 2:]))


def recon_min_plain(p: BandPieces, edges: torch.Tensor, above: Optional[torch.Tensor],
                    below: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of recon_min: each foreground pixel of row 0 (row Hb -
    1) takes _adj of above (below); where that is below its snapshot value
    its piece's value is lowered to it (scatter_reduce_ amin) and p.flag
    set to 1. Returns p.flag."""
    N, nblk = p.val.shape
    for e, nb in ((0, above), (-1, below)):
        if nb is None:
            continue
        lab = p.lab[:, e]
        cand = _adj(nb, p.sent)
        hit = (lab != p.sent) & (cand < edges[:, e])
        n_i, x_i = hit.nonzero(as_tuple=True)
        idx = n_i * nblk + ((lab[n_i, x_i] - p.kbase) >> 2).long()
        p.val.view(-1).scatter_reduce_(0, idx, cand[n_i, x_i], "amin")
        p.flag.copy_(torch.maximum(p.flag, hit.any().to(torch.int32)))
    return p.flag


def recon_min(p: BandPieces, edges: torch.Tensor, above: Optional[torch.Tensor],
              below: Optional[torch.Tensor]) -> torch.Tensor:
    """KB-recon's minimum: the band's pieces lowered by the neighbour bands'
    snapshot rows of this round, above (N, W) the band above's last row
    and below (N, W) the band below's first row (None at the image's edge;
    any frame stride, on p's device); edges: this band's recon_edges of
    the round. Returns p.flag, (1,) int32: 1 where a piece fell. CUDA:
    one launch of tpuva_kb_recon_min."""
    if p.lab.device.type == "cpu":
        return recon_min_plain(p, edges, above, below)
    return _recon_min_cuda(p, edges, above, below)


def _recon_min_cuda(p: BandPieces, edges, above, below) -> torch.Tensor:
    ptrs = []
    for nb in (above, below):
        if nb is None:
            ptrs += [None, 0]
            continue
        if nb.device != p.lab.device or nb.dtype != torch.int32 or nb.stride(1) != 1:
            raise ValueError("recon_min: neighbour rows must be int32 rows on the band's card")
        ptrs += [nb.data_ptr(), nb.stride(0)]
    _build.launch(p.lab.device, "tpuva_kb_recon_min", "recon min kernel", p.lab.data_ptr(),
                  p.val.data_ptr(), edges.data_ptr(), *ptrs, *_band_args(p), p.flag.data_ptr())
    recon_min.launches += 1
    return p.flag


recon_min.launches = 0


def piece_table_plain(p: BandPieces, C: int) -> torch.Tensor:
    """Plain version of piece_table: tpuva's selection, the C largest of
    value + 1 over the band's roots (topk, with multiplicity), adjacent
    duplicates and absent entries sent + 2, sorted ascending: (N, C)
    int32."""
    N, cap = p.roots.shape
    live = torch.arange(cap, device=p.roots.device)[None, :] < p.nroots[:, None]
    vals = torch.where(live, p.val.gather(1, p.roots.long()) + 1, 0)
    k = min(C, cap)
    top = torch.topk(vals, k, dim=1).values  # descending, duplicates adjacent
    if k < C:
        top = F.pad(top, (0, C - k))
    dup = torch.zeros_like(top, dtype=torch.bool)
    dup[:, 1:] = top[:, 1:] == top[:, :-1]
    return torch.where((top > 0) & ~dup, top, p.sent + 2).sort(dim=1).values


def piece_table(p: BandPieces, C: int) -> torch.Tensor:
    """KB-table's selection: (N, C) int32, each frame's distinct values + 1
    of the C largest of its band's pieces (with multiplicity, tpuva's
    top_k), ascending, then sent + 2. CUDA: one launch of tpuva_kb_table,
    a CTA a frame."""
    if C < 1:
        raise ValueError("piece_table: C >= 1")
    if p.lab.device.type == "cpu":
        return piece_table_plain(p, C)
    return _piece_table_cuda(p, C)


def _piece_table_cuda(p: BandPieces, C: int) -> torch.Tensor:
    N = p.lab.shape[0]
    dev = p.lab.device
    table = torch.empty((N, C), dtype=torch.int32, device=dev)
    # the sort's scratch, used where the candidates outgrow shared memory
    scratch = torch.empty((N, 1 << (C - 1).bit_length()), dtype=torch.int32, device=dev)
    _build.launch(dev, "tpuva_kb_table", "piece table kernel", p.val.data_ptr(),
                  p.roots.data_ptr(), p.nroots.data_ptr(), *_band_args(p), C,
                  scratch.data_ptr(), table.data_ptr())
    piece_table.launches += 1
    return table


piece_table.launches = 0


def piece_sums_plain(p: BandPieces, table: torch.Tensor) -> torch.Tensor:
    """Plain version of piece_sums: (N, C, 3) int64 sums of (1, x, y0 + y)
    over the band's pixels whose value + 1 is in their frame's table
    (searchsorted, index_add_); pixels of pieces past the table are
    dropped, as tpuva drops them."""
    N, _Hb, _W = p.lab.shape
    C = table.shape[1]
    n_idx, q_idx = (p.lab != p.sent).reshape(N, -1).nonzero(as_tuple=True)
    lab = p.lab.reshape(N, -1)[n_idx, q_idx]
    v = p.val[n_idx, ((lab - p.kbase) >> 2).long()].long() + 1
    stride = 1 << 33  # above every value and the sentinel: frames stay sorted
    flat = (table.long() + torch.arange(N, device=table.device)[:, None] * stride).reshape(-1)
    q = v + n_idx * stride
    pos = torch.searchsorted(flat, q).clamp(max=N * C - 1)
    hit = flat[pos] == q
    n_idx = n_idx[hit]
    sums = _pixel_sums(p.lab.shape, C, n_idx, q_idx[hit], pos[hit] - n_idx * C)
    sums[..., 2] += p.y0 * sums[..., 0]  # the band's rows in image coordinates
    return sums


def piece_sums(p: BandPieces, table: torch.Tensor) -> torch.Tensor:
    """KB-table's sums: (N, C, 3) int64 of (1, x, y0 + y) over the band's
    pixels whose value + 1 is in their frame's table (piece_table's).
    CUDA: one launch of tpuva_kb_sums over KB-labels' occupied strips."""
    if p.lab.device.type == "cpu":
        return piece_sums_plain(p, table)
    return _piece_sums_cuda(p, table)


def _piece_sums_cuda(p: BandPieces, table: torch.Tensor) -> torch.Tensor:
    N, C = table.shape
    if p.occ is None or table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError("piece_sums: KB-labels' pieces and an int32 (N, C) table")
    sums = torch.empty((N, C, 3), dtype=torch.int64, device=p.lab.device)
    _build.launch(p.lab.device, "tpuva_kb_sums", "piece sums kernel", p.lab.data_ptr(),
                  p.val.data_ptr(), p.occ.data_ptr(), *_band_args(p), table.data_ptr(), C,
                  sums.data_ptr())
    piece_sums.launches += 1
    return sums


piece_sums.launches = 0
