"""The tracker scan over a batch's frames — kernel K5 and its plain version.

Replaces tpuva's ``lax.scan`` of ``track/table.py::track_update`` in
``graph/pipeline.py::_finish_batch`` (with ``track/assign.py``'s
``hungarian_assign`` or ``greedy_assign``): frame by frame, the cost
between the table's tracks and the frame's detections, the assignment, the
matched updates, deaths compacted down, births appended, and one row per
matched or born detection.

- CUDA tensors launch ``csrc/track.cu``: one CTA walks the N frames in
  order with the table in shared memory (or in a global scratch buffer
  where a large table does not fit), the Hungarian search included, so a
  batch is one launch and no frame is read on the host.
- CPU tensors take the plain version, ``track_scan_plain``: one
  ``track_update`` a frame, the loop ``_finish_batch`` ran before the
  kernel.

Both return the same bits: rows, row_valid and every state tensor. The
input state is left untouched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuva_torch import _build
from tpuva_torch.track.table import TrackState, track_update

ASSIGNERS = ("greedy", "hungarian")


def track_scan_plain(state: TrackState, dets: torch.Tensor, det_valid: torch.Tensor,
                     frame_idx0, *, max_dist: float, death_patience: int,
                     assigner: str = "greedy"):
    """Plain PyTorch version of the kernel: track_update for frames
    frame_idx0 + t, t = 0..N-1, in order (N >= 1)."""
    ts = state
    rows, row_valid = [], []
    for t in range(dets.shape[0]):
        ts, r, rv = track_update(
            ts, dets[t], det_valid[t], frame_idx0 + t,
            max_dist=max_dist,
            death_patience=death_patience,
            assigner=assigner,
        )
        rows.append(r)
        row_valid.append(rv)
    return ts, torch.stack(rows), torch.stack(row_valid)


def track_scan(state: TrackState, dets: torch.Tensor, det_valid: torch.Tensor, frame_idx0, *,
               max_dist: float, death_patience: int, assigner: str = "greedy"):
    """dets (N, D, 3) float32 of (x, y, area), det_valid (N, D) bool, the
    frames' global index frame_idx0 + t from an int32 () tensor (or an
    int) -> (new_state, rows (N, D, 5) float32 of (track_id, frame, x, y,
    area), row_valid (N, D) bool). CPU tensors run track_scan_plain; CUDA
    tensors launch the kernel, which reads frame_idx0 on the card."""
    if assigner not in ASSIGNERS:
        raise ValueError(f"track_scan: assigner must be one of {ASSIGNERS}, got {assigner!r}")
    if dets.dim() != 3 or dets.shape[2] != 3 or dets.dtype != torch.float32:
        raise ValueError("track_scan: dets must be (N, D, 3) float32")
    N, D, _ = dets.shape
    if det_valid.shape != (N, D) or det_valid.dtype != torch.bool:
        raise ValueError("track_scan: det_valid must be (N, D) bool")
    dev = dets.device
    if not isinstance(frame_idx0, torch.Tensor):
        frame_idx0 = torch.tensor(frame_idx0, dtype=torch.int32, device=dev)
    if N == 0:
        return (TrackState(*(x.clone() for x in state)),
                torch.empty((0, D, 5), dtype=torch.float32, device=dev),
                torch.empty((0, D), dtype=torch.bool, device=dev))
    kw = dict(max_dist=max_dist, death_patience=death_patience, assigner=assigner)
    if dev.type == "cpu":
        return track_scan_plain(state, dets, det_valid, frame_idx0, **kw)
    if dev.type != "cuda":
        raise ValueError(f"track_scan: unsupported device {dev}")
    out = _track_scan_cuda(state, dets.contiguous(), det_valid.contiguous(), frame_idx0, **kw)
    track_scan.launches += 1
    return out


def _track_scan_cuda(state, dets, det_valid, frame_idx0, *, max_dist, death_patience, assigner):
    """The launch, on CUDA tensors that track_scan checked."""
    N, D, _ = dets.shape
    T = state.pos.shape[0]
    dev = dets.device
    want = {"pos": ((T, 2), torch.float32), "tid": ((T,), torch.int32),
            "missed": ((T,), torch.int32), "active": ((T,), torch.bool),
            "next_id": ((), torch.int32)}
    for name, (shape, dtype) in want.items():
        x = getattr(state, name)
        if x.shape != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"track_scan: state.{name} must be {shape} {dtype} on {dev}")
    if frame_idx0.shape != () or frame_idx0.dtype != torch.int32 or frame_idx0.device != dev:
        raise ValueError("track_scan: frame_idx0 must be a () int32 tensor on the dets' device")
    if T < 1 or D < 1:
        raise ValueError("track_scan: the kernel needs max_tracks >= 1 and max_blobs >= 1")
    lib = _build.load()
    need = ctypes.c_longlong(0)
    _build.check(lib, lib.tpuva_track_scan_scratch(T, D, ctypes.addressof(need)),
                 "track_scan scratch")
    scratch = torch.empty(need.value, dtype=torch.uint8, device=dev) if need.value else None
    src = [x.contiguous() for x in state]
    new = TrackState(*(torch.empty_like(x) for x in src))
    rows = torch.empty((N, D, 5), dtype=torch.float32, device=dev)
    row_valid = torch.empty((N, D), dtype=torch.bool, device=dev)
    err = lib.tpuva_track_scan(
        dets.data_ptr(), det_valid.data_ptr(), N, T, D,
        *(x.data_ptr() for x in src), frame_idx0.data_ptr(),
        *(x.data_ptr() for x in new), rows.data_ptr(), row_valid.data_ptr(),
        float(np.float32(max_dist)), int(death_patience), int(assigner == "hungarian"),
        scratch.data_ptr() if scratch is not None else None, need.value,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "track_scan kernel")
    return new, rows, row_valid


track_scan.launches = 0
