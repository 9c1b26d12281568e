"""Fixed-capacity track table — port of ``tpuva/track/table.py``.

Same straight-line form and layout invariant as the original (its module
docstring, table.py:9-24): active tracks occupy slots [0, n_active) in
ascending-id order, free slots hold pos=0, tid=0, missed=0; deaths compact
the survivors down (before births), births append at the end. Every
position moves by a one-term masked sum (0 + x == x), never a product, so
positions stay bit-exact; the cost is sqrt(dx*dx + dy*dy) as separate ops.
Semantics are those of refimpl.tracker.Tracker.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuva_torch.track.assign import BIG, greedy_assign, hungarian_assign


class TrackState(NamedTuple):
    pos: torch.Tensor  # (MAX_TRACKS, 2) float32 — last known (x, y)
    tid: torch.Tensor  # (MAX_TRACKS,) int32 — track id, 0 if slot free
    missed: torch.Tensor  # (MAX_TRACKS,) int32 — consecutive unmatched frames
    active: torch.Tensor  # (MAX_TRACKS,) bool
    next_id: torch.Tensor  # () int32 — next id to assign (ids start at 1)


def init_track_state(max_tracks: int, device="cpu") -> TrackState:
    return TrackState(
        pos=torch.zeros((max_tracks, 2), dtype=torch.float32, device=device),
        tid=torch.zeros((max_tracks,), dtype=torch.int32, device=device),
        missed=torch.zeros((max_tracks,), dtype=torch.int32, device=device),
        active=torch.zeros((max_tracks,), dtype=torch.bool, device=device),
        next_id=torch.ones((), dtype=torch.int32, device=device),
    )


def _compact(still, ti, pos, tid, missed):
    """Permute survivors down to slots [0, n_still), preserving order;
    freed slots come out as pos=0/tid=0/missed=0."""
    s32 = still.to(torch.int32)
    srank = torch.cumsum(s32, 0, dtype=torch.int32) - s32
    om = still[None, :] & (srank[None, :] == ti[:, None])  # (new, old)
    pos_c = torch.where(om[:, :, None], pos[None, :, :], 0.0).sum(1)
    tid_c = torch.where(om, tid[None, :], 0).sum(1).to(torch.int32)
    missed_c = torch.where(om, missed[None, :], 0).sum(1).to(torch.int32)
    return pos_c, tid_c, missed_c


def track_update(
    state: TrackState,
    dets: torch.Tensor,  # (D, 3) float32 (x, y, area)
    det_valid: torch.Tensor,  # (D,) bool
    frame_idx,  # int or () int32 tensor
    max_dist: float,
    death_patience: int,
    assigner: str = "greedy",
):
    """One tracker step. Returns (new_state, rows (D, 5) float32,
    row_valid (D,) bool). Row = (track_id, frame, x, y, area)."""
    T = state.pos.shape[0]
    D = dets.shape[0]
    dev = dets.device
    ti = torch.arange(T, dtype=torch.int32, device=dev)

    # ---- cost matrix (slot order == reference list order)
    dx = state.pos[:, 0:1] - dets[None, :, 0]
    dy = state.pos[:, 1:2] - dets[None, :, 1]
    cost = torch.sqrt(dx * dx + dy * dy)
    pairable = state.active[:, None] & det_valid[None, :]
    cost = torch.where(pairable, cost, float(BIG))
    assign = hungarian_assign if assigner == "hungarian" else greedy_assign
    slot_for_det = assign(cost, max_dist)
    det_matched = slot_for_det >= 0

    # ---- matched updates
    eq2 = (slot_for_det[None, :] == ti[:, None]) & det_matched[None, :]
    slot_matched = eq2.any(1)
    matched_pos = torch.where(eq2[:, :, None], dets[None, :, :2], 0.0).sum(1)
    pos = torch.where(slot_matched[:, None], matched_pos, state.pos)
    missed = torch.where(
        slot_matched,
        0,
        torch.where(state.active, state.missed + 1, state.missed),
    ).to(torch.int32)
    row_tid_matched = torch.where(eq2, state.tid[:, None], 0).sum(0).to(torch.int32)

    # ---- deaths compact the survivors down, before births
    still = state.active & (missed < death_patience)
    n_still = still.to(torch.int32).sum()
    pos, tid, missed = _compact(still, ti, pos, state.tid, missed)

    # ---- births: the r-th birthable detection appends at slot n_still + r - 1
    birth_det = det_valid & ~det_matched
    birth_rank = torch.cumsum(birth_det.to(torch.int32), 0, dtype=torch.int32)
    can_birth = birth_det & (n_still + birth_rank <= T)
    slot_for_birth = n_still + birth_rank - 1
    new_tid_for_det = torch.where(
        can_birth, state.next_id - 1 + birth_rank, 0
    ).to(torch.int32)
    bo = (slot_for_birth[None, :] == ti[:, None]) & can_birth[None, :]
    has_b = bo.any(1)
    birth_pos = torch.where(bo[:, :, None], dets[None, :, :2], 0.0).sum(1)
    pos = torch.where(has_b[:, None], birth_pos, pos)
    tid = torch.where(
        has_b, torch.where(bo, new_tid_for_det[None, :], 0).sum(1), tid
    ).to(torch.int32)
    n_births = can_birth.to(torch.int32).sum()
    new_state = TrackState(
        pos=pos,
        tid=tid,
        missed=missed,
        active=ti < n_still + n_births,
        next_id=(state.next_id + n_births).to(torch.int32),
    )

    # ---- trajectory rows, one per matched-or-birthed detection
    row_tid = torch.where(det_matched, row_tid_matched, new_tid_for_det)
    row_valid = det_matched | can_birth
    frame = torch.as_tensor(frame_idx, device=dev).to(torch.float32)
    rows = torch.stack(
        [row_tid.to(torch.float32), frame.expand(D), dets[:, 0], dets[:, 1], dets[:, 2]],
        dim=-1,
    )
    return new_state, rows, row_valid
