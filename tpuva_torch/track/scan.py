"""The tracker scan over a batch's frames — kernel K5 and its plain version.

Replaces tpuva's ``lax.scan`` of ``track/table.py::track_update`` in
``graph/pipeline.py::_finish_batch`` (with ``track/assign.py``'s
``hungarian_assign`` or ``greedy_assign``): frame by frame, the cost
between the table's tracks and the frame's detections, the assignment, the
matched updates, deaths compacted down, births appended, and one row per
matched or born detection.

- CUDA tensors launch ``csrc/track.cu``: one warp walks the N frames in
  order, the Hungarian search included, so a batch is one launch and no
  frame is read on the host. ``scan_plan`` says which kernel takes a
  (max_tracks, max_blobs) table: up to 32 x 32 the table and the cost
  matrix live in registers, a lane a slot and a detection, with the
  detections staged into shared memory a chunk of frames ahead; a larger
  table takes the kernel that keeps it in shared memory (or in a global
  scratch buffer where it does not fit).
- CPU tensors take the plain version, ``track_scan_plain``: one
  ``track_update`` a frame, the loop ``_finish_batch`` ran before the
  kernel.

Both return the same bits: rows, row_valid and every state tensor. The
input state is left untouched.

A stream axis: a state whose tensors lead with (S,), dets (S, N, D, 3),
det_valid (S, N, D) and frame indices (S,) are S independent streams,
each its own table; the kernel takes them in one launch (a CTA a stream),
the plain version one stream after another.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpuva_torch import _build
from tpuva_torch.track.table import TrackState, track_update

ASSIGNERS = ("greedy", "hungarian")
KERNELS = ("registers", "shared", "global")  # scan_plan's kernels, csrc/track.cu's kinds
REGISTER_MAX = 32  # max_tracks and max_blobs the register kernel takes: a lane each
CHUNK_FRAMES = 32  # frames of detections the register kernel stages a chunk
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may use


class ScanPlan(NamedTuple):
    kernel: str  # one of KERNELS
    kd: int  # the register kernel's array extent (8, 16 or 32), 0 for the others
    smem_bytes: int  # dynamic shared memory of the launch
    scratch_bytes: int  # global scratch the wrapper allocates (the "global" kernel)


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def scan_plan(T: int, D: int) -> ScanPlan:
    """Which of csrc/track.cu's kernels takes a table of T slots and D
    detections a frame, and its memory: the pure mirror of
    tpuva_track_scan_plan, which the wrapper holds it to at every launch.

    - "registers" (T <= 32 and D <= 32): a lane a slot and a detection;
      shared memory for the Jonker-Volgenant arrays, two staging buffers
      of CHUNK_FRAMES frames of dets (12 B each) and det_valid, and a
      chunk's rows (20 B) and row_valid, each 16-byte aligned;
    - "shared": the table kernel with its arrays in shared memory;
    - "global": the same kernel with them in a global scratch buffer,
      where they exceed SMEM_LIMIT."""
    if T < 1 or D < 1:
        raise ValueError("scan_plan: the kernels need max_tracks >= 1 and max_blobs >= 1")
    # the table kernel's arrays, in 4-byte words: two tables (pos 2T, tid,
    # missed, active), the cost matrix, three per-detection arrays and
    # seven Jonker-Volgenant arrays of max(T, D) + 1
    table = 4 * (2 * 5 * T + T * D + 3 * D + 7 * (max(T, D) + 1))
    if T <= REGISTER_MAX and D <= REGISTER_MAX:
        F = CHUNK_FRAMES
        smem = (_up16(table) + 2 * _up16(12 * F * D) + 2 * _up16(F * D) + _up16(20 * F * D)
                + _up16(F * D))
        return ScanPlan("registers", 8 if D <= 8 else 16 if D <= 16 else 32, smem, 0)
    if table <= SMEM_LIMIT:
        return ScanPlan("shared", 0, table, 0)
    return ScanPlan("global", 0, 0, table)


def track_scan_plain(state: TrackState, dets: torch.Tensor, det_valid: torch.Tensor,
                     frame_idx0, *, max_dist: float, death_patience: int,
                     assigner: str = "greedy"):
    """Plain PyTorch version of the kernel: track_update for frames
    frame_idx0 + t, t = 0..N-1, in order (N >= 1); with a stream axis
    (dets (S, N, D, 3)), each stream in turn, the results stacked."""
    kw = dict(max_dist=max_dist, death_patience=death_patience, assigner=assigner)
    if dets.dim() == 4:
        outs = [track_scan_plain(TrackState(*(x[s] for x in state)), dets[s], det_valid[s],
                                 frame_idx0[s], **kw) for s in range(dets.shape[0])]
        return (TrackState(*(torch.stack(f) for f in zip(*(o[0] for o in outs)))),
                torch.stack([o[1] for o in outs]), torch.stack([o[2] for o in outs]))
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
    tensors launch the kernel, which reads frame_idx0 on the card.

    With a stream axis — dets (S, N, D, 3), det_valid (S, N, D), a state
    whose tensors lead with (S,) and frame_idx0 (S,) — the S streams are
    scanned independently, in one launch on the card, and every output
    leads with (S,)."""
    if assigner not in ASSIGNERS:
        raise ValueError(f"track_scan: assigner must be one of {ASSIGNERS}, got {assigner!r}")
    if dets.dim() not in (3, 4) or dets.shape[-1] != 3 or dets.dtype != torch.float32:
        raise ValueError("track_scan: dets must be (N, D, 3) or (S, N, D, 3) float32")
    lead = tuple(dets.shape[:-3])  # (S,) with a stream axis
    N, D, _ = dets.shape[-3:]
    if det_valid.shape != lead + (N, D) or det_valid.dtype != torch.bool:
        raise ValueError("track_scan: det_valid must be dets' (..., N, D) bool")
    dev = dets.device
    if not isinstance(frame_idx0, torch.Tensor):
        frame_idx0 = torch.tensor(frame_idx0, dtype=torch.int32, device=dev)
    if N == 0:
        return (TrackState(*(x.clone() for x in state)),
                torch.empty(lead + (0, D, 5), dtype=torch.float32, device=dev),
                torch.empty(lead + (0, D), dtype=torch.bool, device=dev))
    kw = dict(max_dist=max_dist, death_patience=death_patience, assigner=assigner)
    if dev.type == "cpu":
        return track_scan_plain(state, dets, det_valid, frame_idx0, **kw)
    if dev.type != "cuda":
        raise ValueError(f"track_scan: unsupported device {dev}")
    out, plan = _track_scan_cuda(state, dets.contiguous(), det_valid.contiguous(), frame_idx0,
                                 **kw)
    track_scan.launches += 1
    track_scan.kept_launches += plan.kernel != "registers"
    track_scan.stream_launches += bool(lead)
    return out


def _track_scan_cuda(state, dets, det_valid, frame_idx0, *, max_dist, death_patience, assigner):
    """The launch, on CUDA tensors that track_scan checked (with or without
    a stream axis)."""
    lead = tuple(dets.shape[:-3])
    S = lead[0] if lead else 1
    N, D, _ = dets.shape[-3:]
    T = state.pos.shape[-2]
    dev = dets.device
    want = {"pos": ((T, 2), torch.float32), "tid": ((T,), torch.int32),
            "missed": ((T,), torch.int32), "active": ((T,), torch.bool),
            "next_id": ((), torch.int32)}
    for name, (shape, dtype) in want.items():
        x = getattr(state, name)
        if x.shape != lead + shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"track_scan: state.{name} must be {lead + shape} {dtype} on {dev}")
    if frame_idx0.shape != lead or frame_idx0.dtype != torch.int32 or frame_idx0.device != dev:
        raise ValueError(f"track_scan: frame_idx0 must be a {lead} int32 tensor on the dets' "
                         "device")
    if T < 1 or D < 1:
        raise ValueError("track_scan: the kernel needs max_tracks >= 1 and max_blobs >= 1")
    lib = _build.load()
    kind, kd = ctypes.c_int(0), ctypes.c_int(0)
    smem, need = ctypes.c_longlong(0), ctypes.c_longlong(0)
    _build.check(lib, lib.tpuva_track_scan_plan(
        T, D, *map(ctypes.addressof, (kind, kd, smem, need))), "track_scan plan")
    plan = scan_plan(T, D)
    card = (KERNELS[kind.value], kd.value, smem.value, need.value)
    if card != plan:
        raise RuntimeError(f"track_scan: csrc/track.cu plans {card} for ({T}, {D}), "
                           f"scan_plan {plan}")
    scratch = (torch.empty(S * need.value, dtype=torch.uint8, device=dev) if need.value
               else None)
    src = [x.contiguous() for x in state]
    frame0 = frame_idx0.contiguous()
    new = TrackState(*(torch.empty_like(x) for x in src))
    rows = torch.empty(lead + (N, D, 5), dtype=torch.float32, device=dev)
    row_valid = torch.empty(lead + (N, D), dtype=torch.bool, device=dev)
    _build.launch(
        dev, "tpuva_track_scan", "track_scan kernel",
        dets.data_ptr(), det_valid.data_ptr(), S, N, T, D,
        *(x.data_ptr() for x in src), frame0.data_ptr(),
        *(x.data_ptr() for x in new), rows.data_ptr(), row_valid.data_ptr(),
        float(np.float32(max_dist)), int(death_patience), int(assigner == "hungarian"),
        scratch.data_ptr() if scratch is not None else None, S * need.value,
    )
    return (new, rows, row_valid), plan


track_scan.launches = 0  # every K5 launch
track_scan.kept_launches = 0  # those of the table kernel (scan_plan: "shared" or "global")
track_scan.stream_launches = 0  # those with a stream axis (S streams in one launch)
