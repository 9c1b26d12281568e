"""One video stream banded by rows across devices — port of
``tpuva/dist/spatial.py`` (tpuva's spatial tensor parallelism).

A mesh here is a tuple of ``torch.device``s that one process drives, as
tpuva's ``Mesh`` under ``shard_map``: band b of every frame, and the same
rows of the background, live on ``mesh[b]``; a device may hold several
bands. tpuva's collectives become tensor copies between the bands'
devices (views where they share one): ``ppermute`` of edge rows is a
``.to()`` of those rows, ``psum``/``pmax`` a sum or max brought to band 0's
device, ``all_gather`` a concatenation there. Each band's work runs under
its device (``device.on_device``). Per batch:

1. the front end on the band's rows extended by ``_halo_rows`` rows on its
   interior sides only (``graph.pipeline._front_end_emit``: kernel K1
   where it takes the config, K1b/K1m where ``k1_split`` says, K1b, K7 and
   K1 for a median k > 3). tpuva synthesises REFLECT_101 rows at the true
   image borders and keeps cv2's identity border there for its
   morphology; K1 does both at its array's first and last rows, which
   are exactly the true borders, and the halo absorbs its array-edge
   effects at interior edges. For Otsu each band histograms its interior
   rows (kernel K4), the histograms are summed, and every band takes the
   frame's threshold, compare and morphology;
2. band CCL on GLOBAL 8-connected block-raster scan keys: each piece of
   a band its minimum global key (kernel KB-labels,
   ``ops.band_ccl.band_labels``, read in place from the band's mask;
   tpuva's fixed point of the neighbour min and four segmented min-scans),
   a piece's value kept once, at its root block;
3. reconciliation: each round snapshots every band's two edge rows as
   their values (KB-recon ``recon_edges``), then lowers each piece by its
   neighbours' snapshot rows (``recon_min``), until no band changes, one
   host read a round; ``tp_recon_rounds`` counts the rounds;
4. per band the table of piece values (tpuva's selection: the C largest,
   adjacent duplicates dropped; KB-table ``piece_table``) and each
   piece's exact int64 sums of (1, x, y) in global coordinates
   (``piece_sums``; tpuva contracts a bf16 one-hot on the MXU, at 1080p a
   tensor of GBs a band);
5. the tables merged by ascending key (cv2's id order, the first C
   kept), ``_assemble_stats``, the overflow summed over bands;
6. the tracker tail ``_finish_batch`` (kernel K5) on band 0's device.

Bit-identical to the single-device ``process_batch``
(``tests/test_torch_spatial.py``), so the rows, the carried background and
the track table are those of one device; ``stats_overflow`` differs where
a band holds more pieces than its table (tpuva's count, summed over the
bands).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpuva_torch.device import mesh_devices, on_device
from tpuva_torch.graph.pipeline import (
    PipelineCarry,
    _finish_batch,
    _front_end_emit,
    _otsu_mask,
)
from tpuva_torch.ops.band_ccl import (
    band_labels,
    piece_sums,
    piece_table,
    recon_edges,
    recon_min,
)
from tpuva_torch.ops.filters import histogram_u8, otsu_from_histogram
from tpuva_torch.ops.label import _assemble_stats


def make_space_mesh(n_chips: int, devices: Optional[Sequence] = None) -> tuple:
    """The ('space',) mesh: the first n_chips of `devices` (default the
    visible cards). Raises ValueError when there are fewer."""
    return mesh_devices(n_chips, devices)


def _halo_rows(cfg) -> int:
    """Rows of reach of the front end: blur, median, open and close."""
    rb = cfg.blur.ksize // 2 if cfg.blur else 0
    rm = cfg.median.ksize // 2 if cfg.median else 0
    ro = (
        (cfg.morph_open.ksize // 2) * cfg.morph_open.iterations * 2
        if cfg.morph_open
        else 0
    )
    rc = (
        (cfg.morph_close.ksize // 2) * cfg.morph_close.iterations * 2
        if cfg.morph_close
        else 0
    )
    return max(1, rb + rm + ro + rc)


def _merge(tables: torch.Tensor, sums: torch.Tensor, sent: int, C: int):
    """The bands' tables (N, S*C) and sums (N, S*C, 3) merged by key:
    equal keys summed, ranked ascending (cv2's id order), the first C
    kept. Returns (count (N,) int32 = min(components, C), sums (N, C, 3))."""
    keys, order = tables.sort(dim=1)
    vals = sums.gather(1, order[..., None].expand(-1, -1, 3))
    first = torch.ones_like(keys, dtype=torch.bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    n_roots = (first & (keys <= sent)).sum(1)
    group = torch.cumsum(first, 1) - 1  # the valid keys' groups come first
    agg = torch.zeros_like(vals).scatter_add_(1, group[..., None].expand(-1, -1, 3), vals)
    keep = torch.arange(C, device=keys.device)[None, :] < n_roots[:, None]
    out = torch.where(keep[..., None], agg[:, :C], 0)
    return torch.clamp(n_roots, max=C).to(torch.int32), out


def make_spatial_processor(cfg, H: int, W: int, n_chips: int, mesh: Optional[Sequence] = None,
                           max_components: int = 64):
    """Returns fn(carry, frames) -> (carry, out) with process_batch's
    semantics, band-parallel over the mesh (default: make_space_mesh's
    visible cards). H must divide evenly by n_chips.

    carry: a PipelineCarry whose bg is the full (H, W) background or the
    bands' (H / n_chips, W) rows (a sequence, band b on mesh[b]); the
    returned carry holds the bands. The tracker state, bg_valid and
    frame_idx are replicated on band 0's device (mesh[0]). frames: a full
    (N, H, W) uint8 batch on any device (each band copies its extended
    rows to its own) or the n_chips bands (N, H / n_chips, W).

    out (on mesh[0]): rows, row_valid, n_det, row_sums, active_tracks,
    stats_overflow (N,) int32 — the pieces a band's table dropped, summed
    over bands — and tp_recon_rounds, () int32 on the host."""
    if H % n_chips:
        raise ValueError(f"H={H} not divisible by n_chips={n_chips}")
    mesh = tuple(mesh) if mesh is not None else make_space_mesh(n_chips)
    halo = _halo_rows(cfg)
    Hb = H // n_chips
    if halo > Hb:
        raise ValueError("halo larger than band; use fewer chips")
    if Hb < 2:
        raise ValueError("band must be at least 2 rows")
    if len(mesh) != n_chips:
        raise ValueError(f"the mesh holds {len(mesh)} devices, not n_chips={n_chips}")
    home = mesh[0]
    C = max_components
    sent = ((H + 1) // 2) * ((W + 1) // 2) * 4  # _scan_key(H, W, 8)'s sentinel
    top = [halo if b > 0 else 0 for b in range(n_chips)]
    bot = [halo if b < n_chips - 1 else 0 for b in range(n_chips)]
    otsu = cfg.segment.threshold == "otsu"

    def extended(x, b):
        """Band b's rows of x with the halo on its interior sides, on its
        device: x a full (..., H, W) tensor or the bands' (..., Hb, W)."""
        dev = mesh[b]
        if isinstance(x, torch.Tensor):
            return x[..., b * Hb - top[b]:(b + 1) * Hb + bot[b], :].to(dev)
        parts = [x[b].to(dev)]
        if top[b]:
            parts.insert(0, x[b - 1][..., -halo:, :].to(dev))
        if bot[b]:
            parts.append(x[b + 1][..., :halo, :].to(dev))
        return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0]

    def fn(carry: PipelineCarry, frames):
        bands_in = not isinstance(frames, torch.Tensor)
        if bands_in:
            if len(frames) != n_chips or any(tuple(f.shape[1:]) != (Hb, W) for f in frames):
                raise ValueError(f"frames: {n_chips} bands of (N, {Hb}, {W}) expected")
            N = frames[0].shape[0]
        else:
            if frames.dim() != 3 or tuple(frames.shape[1:]) != (H, W):
                raise ValueError(f"frames must be (N, {H}, {W}), got {tuple(frames.shape)}")
            N = frames.shape[0]
        bg = carry.bg
        if not isinstance(bg, torch.Tensor) and len(bg) != n_chips:
            raise ValueError(f"carry.bg: {n_chips} bands expected, got {len(bg)}")
        bg_valid = carry.bg_valid.to(home)

        # 1. the front end on each extended band
        masks, bg_bands, dus = [], [], []
        for b in range(n_chips):
            with on_device(mesh[b]):
                band_carry = PipelineCarry(bg=extended(bg, b).contiguous(), bg_valid=bg_valid,
                                           track=None, frame_idx=None)
                out_b, bg_last = _front_end_emit(cfg, band_carry, extended(frames, b))
                bg_bands.append(bg_last[top[b]:top[b] + Hb].clone())
                (dus if otsu else masks).append(out_b)
        if otsu:
            hists = []
            for b in range(n_chips):
                with on_device(mesh[b]):
                    hists.append(histogram_u8(dus[b][:, top[b]:top[b] + Hb]).to(home))
            with on_device(home):
                thr = otsu_from_histogram(torch.stack(hists).sum(0))
            for b in range(n_chips):
                with on_device(mesh[b]):
                    masks.append(_otsu_mask(cfg, dus[b], thr.to(mesh[b])))
            del dus

        # 2. band CCL on global scan keys, each band read in place
        pieces = []
        for b in range(n_chips):
            with on_device(mesh[b]):
                pieces.append(band_labels(masks[b], top[b], Hb, b * Hb, sent))
        del masks

        # 3. reconciliation: every band's edge snapshot, then every band's
        # minimum, until no band changes (one host read a round)
        rounds = 0
        while True:
            rounds += 1
            edges = []
            for b in range(n_chips):
                with on_device(mesh[b]):
                    edges.append(recon_edges(pieces[b]))
            flags = []
            for b in range(n_chips):
                with on_device(mesh[b]):
                    above = edges[b - 1][:, 1].to(mesh[b]) if b > 0 else None
                    below = edges[b + 1][:, 0].to(mesh[b]) if b < n_chips - 1 else None
                    flags.append(recon_min(pieces[b], edges[b], above, below).to(home))
            del edges
            if not any(torch.cat(flags).tolist()):
                break

        # 4. per band: the piece table and its exact sums
        tables, sums, n_pieces = [], [], []
        for b in range(n_chips):
            with on_device(mesh[b]):
                table = piece_table(pieces[b], C)
                sums.append(piece_sums(pieces[b], table).to(home))
                tables.append(table.to(home))
                n_pieces.append(pieces[b].nroots.to(home))
        del pieces

        # 5. merge on band 0's device, 6. the tracker tail there
        with on_device(home):
            count, out_sums = _merge(torch.cat(tables, 1), torch.cat(sums, 1), sent, C)
            stats = _assemble_stats(count, out_sums, H, W)
            stats["overflow"] = sum(torch.clamp(p - C, min=0) for p in n_pieces).to(torch.int32)
            stats["ccl_converged"] = True
            rep = PipelineCarry(bg=None, bg_valid=bg_valid, track=type(carry.track)(
                *(x.to(home) for x in carry.track)), frame_idx=carry.frame_idx.to(home))
            new, out = _finish_batch(cfg, rep, stats, bg_bands[0])
        del out["ccl_converged"]
        out["tp_recon_rounds"] = torch.tensor(rounds, dtype=torch.int32)
        return PipelineCarry(bg=tuple(bg_bands), bg_valid=new.bg_valid, track=new.track,
                             frame_idx=new.frame_idx), out

    return fn
