"""Batched segmentation + tracking driver — port of the main path of
``tpuva/graph/pipeline.py``.

``process_batch`` runs an (N, H, W) uint8 batch on the carry's device:

1. ``fused_segment`` (kernel K1): blur -> background -> threshold ->
   open -> close, the background seeded from the filtered first frame
   while the carry has none;
2. ``label_stats`` (kernel K2): 8-connected CCL + per-component stats in
   cv2 id order;
3. ``extract_detections``;
4. ``_finish_batch``: one ``track_update`` per frame, in order.

CUDA tensors launch the hand-written kernels in steps 1-2; CPU tensors run
the same calls through their plain versions. On the host,
``collect_rows_array`` (a copy of the original) divides the exact integer
centroid sums in float64, and ``process_clip`` drives a whole clip.

The carry holds the system's state between batches — the background
(float32), whether it is seeded, the track table and the global frame
index; ``carry_from_numpy`` / ``carry_to_numpy`` move it to and from
tpuva's ``PipelineCarry`` (or any object with the same fields).

Ported so far: the fused (non-Otsu) front-end with median 0 or 3. Otsu
thresholding, median k > 3, streaming and dense labels are still to port
(ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuva_torch.ops.ccl import label_stats
from tpuva_torch.ops.fused_segment import fused_segment
from tpuva_torch.ops.label import extract_detections
from tpuva_torch.track.table import TrackState, init_track_state, track_update


class PipelineCarry(NamedTuple):
    bg: torch.Tensor  # (H, W) float32 background model
    bg_valid: torch.Tensor  # () bool — False until seeded from a frame
    track: TrackState
    frame_idx: torch.Tensor  # () int32 — global index of the next frame


def init_carry(cfg, H: int, W: int, background0: Optional[np.ndarray] = None,
               device="cpu") -> PipelineCarry:
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


def carry_from_numpy(carry, device="cpu") -> PipelineCarry:
    """A carry from any object with PipelineCarry's fields holding arrays
    (numpy, tpuva's JAX PipelineCarry, or tensors)."""
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
    """The same carry with every field a numpy array on the host."""
    def a(x):
        return x.detach().cpu().numpy()

    return PipelineCarry(
        bg=a(carry.bg),
        bg_valid=a(carry.bg_valid),
        track=TrackState(*(a(x) for x in carry.track)),
        frame_idx=a(carry.frame_idx),
    )


def _front_end_kwargs(cfg) -> dict:
    """fused_segment's options from a config (as tpuva's _fused_mask_stage)."""
    return dict(
        alpha=cfg.background.alpha,
        threshold=cfg.segment.threshold,
        blur_ksize=cfg.blur.ksize if cfg.blur else 0,
        blur_sigma=cfg.blur.sigma if cfg.blur else 0.0,
        median_ksize=cfg.median.ksize if cfg.median and cfg.median.ksize > 1 else 0,
        open_shape=cfg.morph_open.shape if cfg.morph_open else "rect",
        open_ksize=cfg.morph_open.ksize if cfg.morph_open else 0,
        open_iters=cfg.morph_open.iterations if cfg.morph_open else 1,
        close_shape=cfg.morph_close.shape if cfg.morph_close else "rect",
        close_ksize=cfg.morph_close.ksize if cfg.morph_close else 0,
        close_iters=cfg.morph_close.iterations if cfg.morph_close else 1,
    )


def process_batch(cfg, carry: PipelineCarry, frames: torch.Tensor,
                  max_components: int = 64, return_masks: bool = False):
    """One N-frame batch. frames: (N, H, W) uint8 on the carry's device.

    Returns (new_carry, out) with out:
      rows           (N, max_blobs, 5) float32 — (track_id, frame, x, y, area)
      row_valid      (N, max_blobs) bool
      row_sums       (N, max_blobs, 2) int32 — exact centroid sums (sx, sy)
      n_det          (N,) int32
      active_tracks  () int32 — end-of-batch active-track count
      stats_overflow (N,) int32, ccl_converged bool — strictness fields
      masks          (N, H, W) uint8, only if return_masks
    """
    if cfg.segment.threshold == "otsu":
        raise NotImplementedError("Otsu thresholding is not ported yet")
    if cfg.median is not None and cfg.median.ksize not in (1, 3):
        raise NotImplementedError("median ksize > 3 is not ported yet")
    masks, bg_last = fused_segment(
        frames, carry.bg, seed_bg=not bool(carry.bg_valid), **_front_end_kwargs(cfg)
    )
    stats = label_stats(masks, max_components)
    new_carry, out = _finish_batch(cfg, carry, stats, masks, bg_last, return_masks)
    out["stats_overflow"] = stats["overflow"]
    out["ccl_converged"] = stats["ccl_converged"]
    return new_carry, out


def _finish_batch(cfg, carry: PipelineCarry, stats, mask, bg_last, return_masks):
    dets, n_det, det_valid, det_sums = extract_detections(
        stats, cfg.segment.min_area, cfg.segment.max_blobs
    )
    N = mask.shape[0]
    ts = carry.track
    rows, row_valid = [], []
    for t in range(N):
        ts, r, rv = track_update(
            ts, dets[t], det_valid[t], carry.frame_idx + t,
            max_dist=cfg.track.max_dist,
            death_patience=cfg.track.death_patience,
            assigner=cfg.track.assigner,
        )
        rows.append(r)
        row_valid.append(rv)
    new_carry = PipelineCarry(
        bg=bg_last,
        bg_valid=torch.ones((), dtype=torch.bool, device=mask.device),
        track=ts,
        frame_idx=(carry.frame_idx + N).to(torch.int32),
    )
    out = {
        "rows": torch.stack(rows),
        "row_valid": torch.stack(row_valid),
        "n_det": n_det,
        "row_sums": det_sums,
        "active_tracks": ts.active.to(torch.int32).sum().to(torch.int32),
    }
    if return_masks:
        out["masks"] = mask
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
                 return_masks: bool = False, max_components: int = 64,
                 device="cpu"):
    """Run a whole (T, H, W) uint8 clip through batched processing on
    `device`. Returns (rows, final_carry, masks-or-None), rows as
    tpuva.graph.pipeline.process_clip returns them.

    The final partial batch is padded by repeating the last frame; padded
    frames' rows are dropped. A frame whose component stats overflowed, or
    a CCL that did not converge, raises: accuracy is never lost silently.
    """
    T, H, W = clip.shape
    N = cfg.batch
    carry = init_carry(cfg, H, W, background0, device)
    all_rows = []
    masks = [] if return_masks else None
    for start in range(0, T, N):
        chunk = clip[start:start + N]
        n = chunk.shape[0]
        if n < N:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], N - n, axis=0)], axis=0)
        frames = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
        carry, out = process_batch(
            cfg, carry, frames, max_components=max_components,
            return_masks=return_masks,
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
    if return_masks:
        masks = np.concatenate(masks, axis=0)
    return all_rows, carry, masks
