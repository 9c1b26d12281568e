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
2. band CCL on GLOBAL 8-connected block-raster scan keys: the
   neighbour-min and four segmented min-scans to a fixed point
   (``_band_sweep``, torch ops as in tpuva, which has no kernel here);
3. reconciliation: the 1-row band edges are exchanged and the bands
   re-swept until no band changes, one host read a round;
   ``tp_recon_rounds`` counts the rounds;
4. per band the table of piece values (tpuva's selection: the C largest,
   adjacent duplicates dropped) and each piece's exact int64 sums of
   (1, x, y) in global coordinates (tpuva contracts a bf16 one-hot on the
   MXU; at 1080p that tensor would take GBs a band);
5. the tables merged by ascending key (cv2's id order, the first C
   kept), ``_assemble_stats``, the overflow summed over bands;
6. the tracker tail ``_finish_batch`` (kernel K5) on band 0's device.

Bit-identical to the single-device ``process_batch``
(``tests/test_torch_spatial.py``), so the rows, the carried background and
the track table are those of one device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from tpuva_torch.device import mesh_devices, on_device
from tpuva_torch.graph.pipeline import (
    PipelineCarry,
    _finish_batch,
    _front_end_emit,
    _otsu_mask,
)
from tpuva_torch.ops.filters import histogram_u8, otsu_from_histogram
from tpuva_torch.ops.label import (
    _assemble_stats,
    _neighbor_min_8,
    _pixel_sums,
    _segmented_min_scan,
)

# pixels a band sweep takes at once: its int64 scan keys stay ~256 MB
SWEEP_PX = 1 << 25


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


def _sweep(label: torch.Tensor, m: torch.Tensor, sent: int) -> torch.Tensor:
    """One sweep: the 8-neighbour min, then the four segmented min-scans."""
    label = torch.where(m, torch.minimum(label, _neighbor_min_8(label, sent)), sent)
    label = _segmented_min_scan(label, m, 2, sent)
    label = _segmented_min_scan(label, m, 2, sent, reverse=True)
    label = _segmented_min_scan(label, m, 1, sent)
    return _segmented_min_scan(label, m, 1, sent, reverse=True)


def _band_sweep(lab: torch.Tensor, m: torch.Tensor, sent: int, precheck: bool = False) -> None:
    """Sweep the band's labels (N, Hb, W) int32 in place to their fixed
    point, SWEEP_PX pixels of frames at a time (frames are independent, so
    each reaches the fixed point tpuva's whole-band loop gives it).

    precheck: a fixed point of the 8-neighbour min is one of the run scans
    too (each scan is an iterated neighbour min along one axis), so frames
    whose neighbour min changes nothing are left as they are — a
    reconciliation round that changed nothing costs one compare."""
    N, Hb, W = lab.shape
    step = max(1, SWEEP_PX // max(1, Hb * W))
    for s in range(0, N, step):
        cur, mc = lab[s:s + step], m[s:s + step]
        if precheck:
            nb = torch.where(mc, torch.minimum(cur, _neighbor_min_8(cur, sent)), sent)
            if torch.equal(nb, cur):
                continue
        while True:
            new = _sweep(cur, mc, sent)
            if torch.equal(new, cur):
                break
            cur = new
        lab[s:s + step] = cur


def _adj(nb: torch.Tensor, sent: int) -> torch.Tensor:
    """8-connected partners of an edge row (N, W): itself and its left and
    right neighbours, sent outside."""
    p = F.pad(nb, (1, 1), value=sent)
    return torch.minimum(nb, torch.minimum(p[:, :-2], p[:, 2:]))


def _piece_table(lab: torch.Tensor, is_root: torch.Tensor, sent: int, C: int):
    """A band's table: the C largest piece values (the reconciled label + 1
    at each pre-reconciliation piece root; tpuva's top_k), adjacent
    duplicates and absent entries sent + 2, sorted ascending. Returns
    (table (N, C) int64, pieces (N,) int64: the band's piece roots)."""
    N = lab.shape[0]
    rootv = torch.where(is_root, lab + 1, 0).reshape(N, -1)
    k = min(C, rootv.shape[1])
    vals = torch.topk(rootv, k, dim=1).values.long()  # descending, dupes adjacent
    if k < C:
        vals = F.pad(vals, (0, C - k))
    dup = torch.zeros_like(vals, dtype=torch.bool)
    dup[:, 1:] = vals[:, 1:] == vals[:, :-1]
    table = torch.where((vals > 0) & ~dup, vals, sent + 2)
    return table.sort(dim=1).values, (rootv > 0).sum(1)


def _table_sums(lab: torch.Tensor, m: torch.Tensor, table: torch.Tensor, y0: int):
    """(N, C, 3) int64 sums of (1, x, y + y0) over the band's pixels whose
    label + 1 is in their frame's sorted table (pixels of pieces past the
    table are dropped, as tpuva drops them)."""
    N, _Hb, _W = lab.shape
    C = table.shape[1]
    n_idx, p_idx = m.reshape(N, -1).nonzero(as_tuple=True)
    stride = 1 << 33  # above every label and the sentinel: frames stay sorted
    flat_table = (table + torch.arange(N, device=lab.device)[:, None] * stride).reshape(-1)
    q = lab.reshape(N, -1)[n_idx, p_idx].long() + 1 + n_idx * stride
    pos = torch.searchsorted(flat_table, q).clamp(max=N * C - 1)
    hit = flat_table[pos] == q
    n_idx = n_idx[hit]
    sums = _pixel_sums(lab.shape, C, n_idx, p_idx[hit], pos[hit] - n_idx * C)
    sums[..., 2] += y0 * sums[..., 0]  # the band's rows in global coordinates
    return sums


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
    Wb2 = (W + 1) // 2
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

    def band_keys(b):
        rr = torch.arange(Hb, dtype=torch.int32, device=mesh[b])[:, None] + b * Hb
        cc = torch.arange(W, dtype=torch.int32, device=mesh[b])[None, :]
        return ((rr >> 1) * Wb2 + (cc >> 1)) * 4 + (rr & 1) * 2 + (cc & 1)

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

        # 2. band CCL on global scan keys
        fg, labs, roots = [], [], []
        for b in range(n_chips):
            with on_device(mesh[b]):
                m = masks[b][:, top[b]:top[b] + Hb] > 0
                kv = band_keys(b)
                lab = torch.where(m, kv[None], sent)
                _band_sweep(lab, m, sent)
                fg.append(m)
                labs.append(lab)
                roots.append(m & (lab == kv[None]))  # each piece's local root
        del masks

        # 3. reconciliation: exchange 1-row edges until no band changes
        rounds = 0
        while True:
            rounds += 1
            edges, flags = [], []
            for b in range(n_chips):
                with on_device(mesh[b]):
                    lab, m = labs[b], fg[b]
                    none = torch.full((N, W), sent, dtype=torch.int32, device=mesh[b])
                    above = labs[b - 1][:, -1].to(mesh[b]) if b > 0 else none
                    below = labs[b + 1][:, 0].to(mesh[b]) if b < n_chips - 1 else none
                    new_top = torch.where(m[:, 0], torch.minimum(lab[:, 0], _adj(above, sent)),
                                          sent)
                    new_bot = torch.where(m[:, -1], torch.minimum(lab[:, -1], _adj(below, sent)),
                                          sent)
                    edges.append((new_top, new_bot))
                    flags.append(torch.any(new_top != lab[:, 0]) | torch.any(new_bot != lab[:, -1]))
            changed = torch.stack([f.to(home) for f in flags]).tolist()  # one host read
            if not any(changed):
                break
            for b in range(n_chips):
                if changed[b]:
                    with on_device(mesh[b]):
                        labs[b][:, 0], labs[b][:, -1] = edges[b]
                        _band_sweep(labs[b], fg[b], sent, precheck=True)
            del edges

        # 4. per band: the piece table and its exact sums
        tables, sums, pieces = [], [], []
        for b in range(n_chips):
            with on_device(mesh[b]):
                table, n_loc = _piece_table(labs[b], roots[b], sent, C)
                sums.append(_table_sums(labs[b], fg[b], table, b * Hb).to(home))
                tables.append(table.to(home))
                pieces.append(n_loc.to(home))
        del labs, roots, fg

        # 5. merge on band 0's device, 6. the tracker tail there
        with on_device(home):
            count, out_sums = _merge(torch.cat(tables, 1), torch.cat(sums, 1), sent, C)
            stats = _assemble_stats(count, out_sums, H, W)
            stats["overflow"] = sum(torch.clamp(p - C, min=0) for p in pieces).to(torch.int32)
            stats["ccl_converged"] = True
            rep = PipelineCarry(bg=None, bg_valid=bg_valid, track=type(carry.track)(
                *(x.to(home) for x in carry.track)), frame_idx=carry.frame_idx.to(home))
            new, out = _finish_batch(cfg, rep, stats, bg_bands[0])
        del out["ccl_converged"]
        out["tp_recon_rounds"] = torch.tensor(rounds, dtype=torch.int32)
        return PipelineCarry(bg=tuple(bg_bands), bg_valid=new.bg_valid, track=new.track,
                             frame_idx=new.frame_idx), out

    return fn
