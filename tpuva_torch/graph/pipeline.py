"""Batched segmentation + tracking pipeline — port of
``tpuva/graph/pipeline.py``.

Two routes over an (N, H, W) uint8 batch on the carry's device, under the
JAX package's names:

- ``process_batch`` — the default, one-dispatch route: the front end
  (``torch_front_end``: blur, median, background, |F - B| > threshold,
  open, close — kernel K1, ``fused_segment``, for the sequential
  background; for ``parallel_bg`` kernel KS, ``ops.background.
  background_scan``, tpuva's associative scan in its combination order,
  between K1b/K7 and K1m); then
  ``connected_components_with_stats`` (kernel K3 + integer stats), or
  kernel K2 with ``ccl_single_pass``; then ``_finish_batch``.
- ``process_batch_staged`` — kernel K1, then kernel K2 (``label_stats``:
  8-connected CCL + stats in one launch sequence), then ``_finish_batch``.
  Where the Pallas tile grid (``fused_tile``) aligns to 64 x 256, as at
  1080p, K1 hands K2 its uncropped padded mask and the strip occupancy
  (``padded_occ``), and K2 visits only the occupied strips; elsewhere, and
  for Otsu, K2 derives the occupancy from the cropped mask — tpuva's two
  handoffs.

tpuva's capacity knobs ``sparse_strips`` and ``compact_slots`` size its
TPU stats buffers; K2 has no capacity (union-find with exact sums), so
the entry points take them and change nothing by them, and
``stats_overflow`` stays zero.

K1 takes every config tpuva's Pallas kernel does (median 0 or 3): where
one launch cannot hold more than 63 blur taps, a structuring element wider
than 31 or a morphology reach whose tile overflows a CTA's shared memory
(``ops.fused_segment.k1_takes``), ``fused_segment`` runs that blur or that
open and close in kernels of their own around it (``k1_split``). A median
k > 3 is where tpuva runs its jnp branch; the port runs it as the median
route (``_median_front_end``): kernel K1b's blur (``blur_u8``) and kernel
K7's median (``ops.median.median_u8``) on the uint8 frames, then K1 without
its blur and median, bit-equal to tpuva's order blur -> median ->
background. The staged route refuses it, as tpuva's does.

Otsu thresholding (``SegmentConfig(threshold="otsu")``) takes every route:
the front end emits the rounded magnitudes ``clip(rint(|F - B|), 0, 255)``
(K1 with ``emit="diff"`` for the sequential background of
``torch_front_end``, on both routes; KS's diff emit for the scanned
background), each frame's threshold comes from its 256-bin histogram (kernel K4 in
``ops.filters.histogram_u8``), then the strict integer compare and the
open and close (``_morphology``: kernel K1m, a launch a ``morph_plan``
group).

``ccl_single_pass`` exists in tpuva because its multi-pass TPU CCL pays
for sequential grid passes. K2's union-find converges in one launch
sequence and gives exact stats, so the flag maps onto K2: the staged
route ignores it and ``process_batch`` takes K2 for its stats, as tpuva's
single-pass tail does.

``_finish_batch`` runs ``extract_detections`` and the tracker scan over the
batch's frames (kernel K5, ``track.scan.track_scan``: one launch a batch,
no host read). CUDA tensors launch the hand-written kernels; CPU tensors
run the same calls through their plain versions. On the host,
``collect_rows_array`` (a copy of the original) divides the exact integer
centroid sums in float64, and ``process_clip`` drives a whole clip,
dispatching as tpuva's does: the staged route for ``use_pallas`` on the
card, the one-dispatch route otherwise.

The carry holds the system's state between batches — the background
(float32), whether it is seeded, the track table and the global frame
index; ``carry_from_numpy`` / ``carry_to_numpy`` move it to and from
tpuva's ``PipelineCarry`` (or any object with the same fields). Entry
points run on the card unless they are given ``device="cpu"``.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.io.staging import BatchStager
from tpuva_torch.ops.background import background_scan, background_update, scan_trajectory
from tpuva_torch.ops.ccl import label_stats, root_labels
from tpuva_torch.ops.filters import otsu_threshold
from tpuva_torch.ops.fused_segment import fused_segment, fused_tile
from tpuva_torch.ops.label import (
    connected_components_with_stats,
    extract_detections,
    relabel_dense,
)
from tpuva_torch.ops.median import median_u8
from tpuva_torch.ops.wide import blur_u8, open_close_u8
from tpuva_torch.track.scan import track_scan
from tpuva_torch.track.table import TrackState, init_track_state


class PipelineCarry(NamedTuple):
    bg: torch.Tensor  # (H, W) float32 background model
    bg_valid: torch.Tensor  # () bool — False until seeded from a frame
    track: TrackState
    frame_idx: torch.Tensor  # () int32 — global index of the next frame


def init_carry(cfg, H: int, W: int, background0: Optional[np.ndarray] = None,
               device="cuda") -> PipelineCarry:
    device = resolve_device(device)
    if background0 is not None:
        bg = torch.as_tensor(np.asarray(background0, np.float32), device=device)
    else:
        bg = torch.zeros((H, W), dtype=torch.float32, device=device)
    return PipelineCarry(
        bg=bg,
        bg_valid=torch.tensor(background0 is not None, device=device),
        track=init_track_state(cfg.track.max_tracks, device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def carry_from_numpy(carry, device="cuda") -> PipelineCarry:
    """A carry from any object with PipelineCarry's fields holding arrays
    (numpy, tpuva's JAX PipelineCarry, or tensors)."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    ts = carry.track
    return PipelineCarry(
        bg=t(carry.bg, torch.float32),
        bg_valid=t(carry.bg_valid, torch.bool),
        track=TrackState(
            pos=t(ts.pos, torch.float32),
            tid=t(ts.tid, torch.int32),
            missed=t(ts.missed, torch.int32),
            active=t(ts.active, torch.bool),
            next_id=t(ts.next_id, torch.int32),
        ),
        frame_idx=t(carry.frame_idx, torch.int32),
    )


def carry_to_numpy(carry: PipelineCarry) -> PipelineCarry:
    """The same carry with every field a numpy array on the host; a
    background held as row bands (a sequence of tensors, the spatial
    processor's carry) is gathered into the full frame."""
    def a(x):
        return x.detach().cpu().numpy()

    bands = isinstance(carry.bg, (list, tuple))
    return PipelineCarry(
        bg=np.concatenate([a(b) for b in carry.bg], axis=-2) if bands else a(carry.bg),
        bg_valid=a(carry.bg_valid),
        track=TrackState(*(a(x) for x in carry.track)),
        frame_idx=a(carry.frame_idx),
    )


def _diff_kwargs(cfg) -> dict:
    """fused_segment's options for emit="diff" (as tpuva's _otsu_mask_stage)."""
    return dict(
        alpha=cfg.background.alpha,
        threshold=0.0,
        blur_ksize=cfg.blur.ksize if cfg.blur else 0,
        blur_sigma=cfg.blur.sigma if cfg.blur else 0.0,
        median_ksize=cfg.median.ksize if cfg.median and cfg.median.ksize > 1 else 0,
        emit="diff",
    )


def _front_end_kwargs(cfg) -> dict:
    """fused_segment's options from a config (as tpuva's _fused_mask_stage)."""
    return dict(
        _diff_kwargs(cfg),
        emit="mask",
        threshold=cfg.segment.threshold,
        open_shape=cfg.morph_open.shape if cfg.morph_open else "rect",
        open_ksize=cfg.morph_open.ksize if cfg.morph_open else 0,
        open_iters=cfg.morph_open.iterations if cfg.morph_open else 1,
        close_shape=cfg.morph_close.shape if cfg.morph_close else "rect",
        close_ksize=cfg.morph_close.ksize if cfg.morph_close else 0,
        close_iters=cfg.morph_close.iterations if cfg.morph_close else 1,
    )


def _filter_u8(cfg, f: torch.Tensor) -> torch.Tensor:
    """The filter prefix of uint8 frames (N, H, W) in tpuva's order, blur
    then median: kernel K1b (blur_u8) and kernel K7 (median_u8) on the
    card, their plain versions on the CPU; uint8 out."""
    if cfg.blur is not None:
        f = blur_u8(f, cfg.blur.ksize, cfg.blur.sigma)
    if cfg.median is not None:
        f = median_u8(f, cfg.median.ksize)
    return f


def filter_batch(cfg, frames: torch.Tensor) -> torch.Tensor:
    """The stateless filter prefix (blur, median) of an (N, H, W) batch of
    integer values in [0, 255] (uint8, or float32 as tpuva's) -> float32, as
    tpuva's filter_batch: the blur re-quantizes to u8 (cv2's fixed point),
    so the median sees the same values cv2's does (_filter_u8)."""
    return _filter_u8(cfg, frames.to(torch.uint8)).to(torch.float32)


def background_trajectory(bg0: torch.Tensor, frames: torch.Tensor, alpha: float,
                          parallel: bool = False) -> torch.Tensor:
    """All post-update backgrounds B_1..B_N of a batch, (N, H, W) float32.

    sequential: one background_update per frame, refimpl's two roundings.
    parallel: an associative scan over the affine maps (s, o) with
    B_t = s_t * B_0 + o_t, O(log N) depth (ops.background.scan_trajectory,
    KS's plain version's); it reorders the float32 work, so it is not
    bit-equal to the sequential form."""
    if not parallel:
        bgs = torch.empty_like(frames)
        b = bg0
        for t in range(frames.shape[0]):
            b = background_update(b, frames[t], alpha)
            bgs[t] = b
        return bgs
    return scan_trajectory(bg0, frames, alpha)


def _can_stage(cfg) -> bool:
    """Whether kernel K1 takes the config's front end, as tpuva's
    _can_stage: median off or 3 (the mask emit for a fixed threshold, the
    diff emit for Otsu; fused_segment splits what one launch cannot hold)."""
    return cfg.median is None or cfg.median.ksize in (1, 3)


def _can_fuse(cfg) -> bool:
    """Configs K1 covers in one pass: those of _can_stage with a fixed
    threshold. Otsu needs each frame's histogram, a statistic no tile
    sees, so K1 only emits its magnitudes (_otsu_mask)."""
    return cfg.segment.threshold != "otsu" and _can_stage(cfg)


def _morph_stages(cfg) -> tuple:
    """The config's open and close as open_close_u8's stages, (shape,
    ksize, iterations) each, ksize 0 where the config has none."""
    kw = _front_end_kwargs(cfg)
    return tuple((kw[f"{m}_shape"], kw[f"{m}_ksize"], kw[f"{m}_iters"]) for m in ("open", "close"))


def _morphology(cfg, mask: torch.Tensor) -> torch.Tensor:
    """The config's open, then close, of an (N, H, W) uint8 mask:
    open_close_u8, kernel K1m on the card (a launch a morph_plan group),
    _morph steps on the CPU."""
    return open_close_u8(mask, _morph_stages(cfg))


def _otsu_mask(cfg, du8: torch.Tensor, thr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rounded magnitudes (N, H, W) uint8 -> mask: each frame's Otsu
    threshold (K4's histogram; or thr (N,) float32 where the caller took
    it, as the spatial processor does from every band's histogram), the
    strict integer compare, open, close."""
    if thr is None:
        thr = otsu_threshold(du8)  # (N,) float32
    zero = torch.zeros((), dtype=torch.uint8, device=du8.device)
    mask = torch.where(du8.to(torch.int32) > thr.to(torch.int32)[:, None, None], zero + 255, zero)
    return _morphology(cfg, mask)


def torch_front_end(cfg, carry: PipelineCarry, frames: torch.Tensor,
                    parallel_bg: bool = False):
    """process_batch's front end: filter_batch -> background_trajectory ->
    |F - B| -> threshold (fixed, or each frame's Otsu threshold of the
    rounded magnitudes) -> open -> close.
    Returns (mask (N, H, W) uint8, post-batch background (H, W) float32).

    The sequential background is kernel K1 (fused_segment; its plain
    version on CPU tensors): the mask emit for a fixed threshold, the diff
    emit then _otsu_mask for Otsu; for a median k > 3 after K1b and K7
    (_median_front_end). The scanned background (parallel_bg: tpuva's
    associative scan, another float32 order than K1's) is kernel KS
    (ops.background.background_scan, order "scan": its mask emit, or its
    diff emit for Otsu; background_scan_plain on CPU tensors) on the
    uint8 frames of _filter_u8 (K1b, K7), then _morphology's K1m, seeded
    as K1 is: from the filtered first frame while the carry has no
    background.

    With a stream axis (a carry of init_multistream_carry, frames
    (S, N, H, W) or a sequence of S (N, H, W) batches) it returns the S·N
    masks in stream order and the (S, H, W) backgrounds: K1 is one launch
    for all streams, each seeded by its flag of ~bg_valid on the device
    (for a median k > 3 after one K1b and one K7 launch over the S·N
    frames); the scanned background runs once a stream (a KS launch a
    stream), as tpuva's jnp branch under vmap."""
    out, bg_last = _front_end_emit(cfg, carry, frames, parallel_bg)
    return (_otsu_mask(cfg, out) if cfg.segment.threshold == "otsu" else out), bg_last


def _front_end_emit(cfg, carry: PipelineCarry, frames: torch.Tensor, parallel_bg: bool = False):
    """torch_front_end short of the Otsu tail: (the mask, or for Otsu the
    rounded magnitudes clip(rint(|F - B|), 0, 255) uint8, post-batch
    background), on the same routes."""
    streams = carry.bg.dim() == 3
    otsu = cfg.segment.threshold == "otsu"
    if not parallel_bg:
        seed_bg = ~carry.bg_valid if streams else not bool(carry.bg_valid)
        emit = _diff_kwargs(cfg) if otsu else _front_end_kwargs(cfg)
        if _can_stage(cfg):
            out, bg_last = fused_segment(frames, carry.bg, seed_bg=seed_bg, **emit)
        else:
            out, bg_last = _median_front_end(cfg, frames, carry.bg, seed_bg, emit)
        return out.flatten(0, out.dim() - 3), bg_last
    if streams:
        outs = [_front_end_emit(cfg, _stream_carry(carry, s), frames[s], parallel_bg)
                for s in range(len(frames))]
        return torch.cat([m for m, _ in outs]), torch.stack([b for _, b in outs])
    f = _filter_u8(cfg, frames.to(torch.uint8))
    out, bg_last = background_scan(f, carry.bg, cfg.background.alpha,
                                   seed_bg=not bool(carry.bg_valid), order="scan",
                                   emit="diff" if otsu else "mask",
                                   threshold=None if otsu else cfg.segment.threshold)
    return (out if otsu else _morphology(cfg, out)), bg_last


def _median_front_end(cfg, frames, bg0: torch.Tensor, seed_bg, emit: dict):
    """The sequential front end of a median k > 3 (the median route):
    kernel K1b's blur (blur_u8) and kernel K7's median (median_u8) on the
    uint8 frames, then kernel K1 (fused_segment) with emit's options less
    its blur and median. Bit-equal to one pass in tpuva's order (blur ->
    median -> background): K1b's output is u8 as the median sees it, and K1
    seeds its background from its input, the filtered first frame. With a
    stream axis (frames (S, N, H, W) or a sequence of S (N, H, W) batches)
    the S·N frames take one K1b and one K7 launch, and K1 one launch for
    all streams. CPU tensors take the plain versions of the same calls."""
    listed = isinstance(frames, (list, tuple))
    streams = listed or frames.dim() == 4
    f = _filter_u8(cfg, torch.cat(list(frames)) if listed
                   else frames.reshape((-1,) + frames.shape[-2:]))
    if streams:
        f = f.reshape(len(frames), -1, *f.shape[1:])
    return fused_segment(f, bg0, seed_bg=seed_bg,
                         **dict(emit, blur_ksize=0, blur_sigma=0.0, median_ksize=0))


def process_batch(cfg, carry: PipelineCarry, frames: torch.Tensor,
                  parallel_bg: bool = False, return_masks: bool = False,
                  max_components: int = 64, use_pallas: bool = False,
                  ccl_single_pass: bool = False, compact_slots: int = 48):
    """One N-frame batch through the one-dispatch route. frames: (N, H, W)
    uint8 on the carry's device; or, with a carry of init_multistream_carry,
    S streams' batches, (S, N, H, W) or a sequence of S (N, H, W), as one
    step (torch_front_end's stream axis, the stats over the S·N frames as
    one batch, one K5 launch), every field of out then leading with (S,)
    and ccl_converged one flag.

    The front end is torch_front_end: kernel K1 for the sequential
    background (the mask emit, or for Otsu the diff emit; after K1b and K7
    for a median k > 3), kernel KS for the scanned one (parallel_bg). With
    use_pallas and a config K1 covers in one pass (_can_fuse), the front
    end is K1 whatever parallel_bg says, as tpuva's fused stage. The CCL is
    connected_components_with_stats, whose root-key labels come from
    kernel K3 on the card; with ccl_single_pass it is K2 (label_stats), as
    tpuva's single-pass tail, with the same rows. compact_slots, the
    capacity of tpuva's compact stats buffer, changes nothing here: K2
    and the dense stats have no capacity to run out of.

    Returns (new_carry, out) with out:
      rows           (N, max_blobs, 5) float32 — (track_id, frame, x, y, area)
      row_valid      (N, max_blobs) bool
      row_sums       (N, max_blobs, 2) int32 — exact centroid sums (sx, sy)
      n_det          (N,) int32
      active_tracks  () int32 — end-of-batch active-track count
      stats_overflow (N,) int32, ccl_converged bool — strictness fields
      masks          (N, H, W) uint8, only if return_masks
    """
    fuse = use_pallas and _can_fuse(cfg)
    mask, bg_last = torch_front_end(cfg, carry, frames, parallel_bg and not fuse)
    if ccl_single_pass:
        stats = label_stats(mask, max_components)
    else:
        stats = connected_components_with_stats(
            mask, max_components=max_components, compute_bbox=False, compute_labels=False
        )
    return _finish_batch(cfg, carry, stats, bg_last, mask if return_masks else None)


def padded_handoff(cfg, H: int, W: int) -> bool:
    """Whether process_batch_staged hands K2 K1's padded mask and
    occupancy, as tpuva's staged route decides: a fixed threshold and a
    fused_tile grid that aligns to 64 x 256 (true at 1080p)."""
    _th, _tw, Hp, Wp = fused_tile(H, W)
    return cfg.segment.threshold != "otsu" and Hp % 64 == 0 and Wp % 256 == 0


def process_batch_staged(cfg, carry: PipelineCarry, frames: torch.Tensor,
                         return_masks: bool = False, max_components: int = 64,
                         sparse_strips: int = 256, compact_slots: int = 48,
                         return_labels: bool = False, ccl_single_pass: bool = False):
    """One N-frame batch through the staged route: kernel K1 with the
    sequential background (seeded from the filtered first frame while the
    carry has none; for Otsu its diff emit, then _otsu_mask), then kernel
    K2's CCL + stats.

    Where padded_handoff holds, K1 runs with padded_occ: K2 takes the
    uncropped (N, Hp, Wp) mask and its strip occupancy, the pairwise max of
    K1's 2 x 128 occ128 over 2 x 256 strips, and visits only the occupied
    strips. Otherwise (and for Otsu) K2 takes the (N, H, W) mask and
    derives the occupancy itself. Same outputs as process_batch; masks
    are the (N, H, W) crop. A median k > 3 raises NotImplementedError, as
    tpuva's staged route refuses it.

    return_labels adds out["labels"], (N, H, W) int32, as tpuva's
    labels_from_raw: dense cv2 ids 1..C of the first C = max_components
    components in cv2 order, 0 for the background and every later
    component (K3's root keys of the cropped mask and its strip occupancy
    through relabel_dense, K6 on the card).
    ccl_single_pass changes nothing here: K2 is exact in one launch
    sequence. sparse_strips and compact_slots size tpuva's TPU stats
    buffers; K2 has none, so they change nothing either."""
    if not _can_stage(cfg):
        raise NotImplementedError("process_batch_staged: median ksize must be 1 or 3")
    if ccl_single_pass and return_labels:
        warnings.warn(  # tpuva's warning: its single-pass kernel leaves no label buffer
            "return_labels=True takes the multi-pass CCL: ccl_single_pass is "
            "ignored for this call; stats/tracking outputs are identical either way.",
            stacklevel=2,
        )
    N, H, W = frames.shape
    if padded_handoff(cfg, H, W):
        padded, bg_last, occ128 = fused_segment(
            frames, carry.bg, seed_bg=not bool(carry.bg_valid), padded_occ=True,
            **_front_end_kwargs(cfg))
        _n, Hp, Wp = padded.shape
        strip_occ = occ128.reshape(N, Hp // 2, Wp // 256, 2).amax(dim=3)
        stats = label_stats(padded, max_components, strip_occ=strip_occ, H=H, W=W)
        masks = padded[:, :H, :W]
    else:
        masks, bg_last = torch_front_end(cfg, carry, frames)
        stats = label_stats(masks, max_components)
    new_carry, out = _finish_batch(cfg, carry, stats, bg_last, masks if return_masks else None)
    if return_labels:
        root, occ = root_labels(masks, 8)
        out["labels"] = relabel_dense(root, max_components, strip_occ=occ)[0]
    return new_carry, out


def _stream_carry(carry: PipelineCarry, s: int) -> PipelineCarry:
    """Stream s's carry of a carry with a stream axis."""
    return PipelineCarry(bg=carry.bg[s], bg_valid=carry.bg_valid[s],
                         track=TrackState(*(x[s] for x in carry.track)),
                         frame_idx=carry.frame_idx[s])


def _finish_batch(cfg, carry: PipelineCarry, stats, bg_last, masks=None):
    """Detections, the tracker (K5) and the outputs of a batch, with
    out["masks"] where the batch's masks are given. With a stream axis
    (bg_last (S, H, W), stats and masks the S·N frames in stream order)
    the tracker is one launch for all streams and every output leads
    with (S,)."""
    lead = tuple(bg_last.shape[:-2])  # (S,) with a stream axis, else ()
    N = stats["overflow"].shape[0] // math.prod(lead)
    D = cfg.segment.max_blobs
    dets, n_det, det_valid, det_sums = extract_detections(stats, cfg.segment.min_area, D)
    ts, rows, row_valid = track_scan(
        carry.track, dets.reshape(*lead, N, D, 3), det_valid.reshape(*lead, N, D),
        carry.frame_idx,
        max_dist=cfg.track.max_dist,
        death_patience=cfg.track.death_patience,
        assigner=cfg.track.assigner,
    )
    new_carry = PipelineCarry(
        bg=bg_last,
        bg_valid=torch.ones(lead, dtype=torch.bool, device=bg_last.device),
        track=ts,
        frame_idx=(carry.frame_idx + N).to(torch.int32),
    )
    out = {
        "rows": rows,
        "row_valid": row_valid,
        "n_det": n_det.reshape(*lead, N),
        "row_sums": det_sums.reshape(*lead, N, D, 2),
        "active_tracks": ts.active.to(torch.int32).sum(dim=-1).to(torch.int32),
        "stats_overflow": stats["overflow"].reshape(*lead, N),
        "ccl_converged": stats["ccl_converged"],
    }
    if masks is not None:
        out["masks"] = masks.reshape(*lead, N, *masks.shape[1:])
    return new_carry, out


def collect_rows_array(rows: np.ndarray, row_valid: np.ndarray,
                       max_frame=None,
                       row_sums: np.ndarray | None = None) -> np.ndarray:
    """Host-side: flatten (N, D, 5) rows into a (k, 5) float64 array of
    (track_id, frame, x, y, area) in (frame, slot) order. With row_sums
    (N, D, 2 int32 of sx, sy), centroids are recomputed as float64
    sx/area — bit-identical to cv2.connectedComponentsWithStats. Copy of
    tpuva.graph.pipeline.collect_rows_array."""
    rows = np.asarray(rows)
    row_valid = np.asarray(row_valid)
    D = rows.shape[-1]
    r2 = rows.reshape(-1, D)
    sel = row_valid.reshape(-1)
    if max_frame is not None:
        sel = sel & (r2[:, 1] < max_frame)
    out = r2[sel].astype(np.float64)
    if row_sums is not None:
        s2 = np.asarray(row_sums).reshape(-1, 2)[sel].astype(np.float64)
        area = out[:, 4]
        out[:, 2] = s2[:, 0] / area
        out[:, 3] = s2[:, 1] / area
    return out


def collect_rows(rows, row_valid, max_frame=None, row_sums=None):
    """collect_rows_array as a list of (int, int, float, float, float)."""
    arr = collect_rows_array(rows, row_valid, max_frame, row_sums)
    return [
        (int(r[0]), int(r[1]), float(r[2]), float(r[3]), float(r[4]))
        for r in arr
    ]


def process_clip(clip: np.ndarray, cfg, background0: Optional[np.ndarray] = None,
                 parallel_bg: bool = False, return_masks: bool = False,
                 max_components: int = 64, use_pallas: bool = False,
                 ccl_single_pass: bool = False, device="cuda"):
    """Run a whole (T, H, W) uint8 clip through batched processing on
    `device`. Returns (rows, final_carry, masks-or-None), rows as
    tpuva.graph.pipeline.process_clip returns them.

    use_pallas with a config K1 takes (_can_stage) takes
    process_batch_staged on the card (K1 + K2); everything else takes
    process_batch (K3, and K1 with use_pallas). The final partial batch is
    padded by repeating the last frame; padded frames' rows are dropped. A
    frame whose component stats overflowed, or a CCL that did not
    converge, raises: accuracy is never lost silently. The batches reach
    the device through BatchStager's ring (pinned slots on a card, one
    host copy of each frame).
    """
    T, H, W = clip.shape
    N = cfg.batch
    carry = init_carry(cfg, H, W, background0, device)
    staged = use_pallas and _can_stage(cfg) and carry.bg.device.type == "cuda"
    all_rows = []
    masks = [] if return_masks else None
    stager = BatchStager(VideoMemory(clip), N, device=carry.bg.device)
    try:
        for n, frames in stager:
            if staged:
                carry, out = process_batch_staged(
                    cfg, carry, frames, return_masks=return_masks,
                    max_components=max_components, ccl_single_pass=ccl_single_pass,
                )
            else:
                carry, out = process_batch(
                    cfg, carry, frames, parallel_bg=parallel_bg, return_masks=return_masks,
                    max_components=max_components, use_pallas=use_pallas,
                    ccl_single_pass=ccl_single_pass,
                )
            ov = out["stats_overflow"][:n].cpu().numpy()
            if (ov > 0).any():
                raise RuntimeError(
                    f"component stats overflow on {int((ov > 0).sum())} frame(s) "
                    "— raise max_components for this workload"
                )
            if not out["ccl_converged"]:
                raise RuntimeError("CCL did not converge")
            all_rows.extend(
                collect_rows(
                    out["rows"].cpu().numpy(), out["row_valid"].cpu().numpy(),
                    max_frame=T, row_sums=out["row_sums"].cpu().numpy(),
                )
            )
            if return_masks:
                masks.append(out["masks"][:n].cpu().numpy())
    finally:
        stager.close()
    if return_masks:
        masks = np.concatenate(masks, axis=0)
    return all_rows, carry, masks
