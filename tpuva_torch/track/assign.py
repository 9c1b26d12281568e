"""Track <-> detection assignment — port of ``tpuva/track/assign.py``.

Both assigners take a dense (T, D) float32 cost matrix with BIG at invalid
pairs and return, for every detection column j, the matched row or -1.

- greedy_assign: repeatedly takes the global minimum entry <= max_dist,
  ties broken by smallest row-major flat index (torch.argmin returns the
  first minimum on CPU and CUDA alike).
- hungarian_assign: the unique-column-minimum fast path (proof in the
  original's docstring, assign.py:187-203), else the exact potentials-
  based Jonker-Volgenant search on the BIG-capped square problem. The
  fast-path test is read on the host once per call; the slow path runs
  as torch ops on a CPU copy of the tiny matrix (its loops branch on
  every step) with the original's float32 operation order.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = np.float32(1e30)


def greedy_assign(cost: torch.Tensor, max_dist) -> torch.Tensor:
    """cost: (T, D). Returns (D,) int32: matched row per column, -1 if none."""
    T, D = cost.shape
    dev = cost.device
    # Python floats holding exact float32 values: a compare or select
    # against them is the float32 one, with no host-to-device copy
    md = float(np.float32(max_dist))
    big = float(BIG)
    rowi = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    coli = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    di = torch.arange(D, dtype=torch.int32, device=dev)
    row_for_col = torch.full((D,), -1, dtype=torch.int32, device=dev)
    c = cost
    for _ in range(min(T, D)):
        flat = torch.argmin(c.reshape(-1)).to(torch.int32)
        v = c.reshape(-1)[flat]
        i, j = flat // D, flat % D
        ok = v <= md
        row_for_col = torch.where(ok & (di == j), i, row_for_col)
        c = torch.where(ok & ((rowi == i) | (coli == j)), big, c)
    return row_for_col


def _hungarian_rect(a: torch.Tensor) -> torch.Tensor:
    """Exact min-cost matching of ALL rows of an (m, n) CPU matrix, m <= n.
    Returns p (n+1,) int32: p[j] (1-indexed column) = 1-indexed row, 0 =
    unmatched. Same float32 operations, in the same order, as the JAX
    original (potentials u, v; Dijkstra over columns; augment on `way`)."""
    m, n = a.shape
    INF = torch.tensor(np.float32(1e38))
    u = torch.zeros(m + 1, dtype=torch.float32)
    v = torch.zeros(n + 1, dtype=torch.float32)
    p = torch.zeros(n + 1, dtype=torch.int32)
    rrows = torch.arange(m + 1, dtype=torch.int32)
    for i in range(1, m + 1):
        p[0] = i
        minv = torch.full((n + 1,), float(INF), dtype=torch.float32)
        way = torch.zeros(n + 1, dtype=torch.int32)
        used = torch.zeros(n + 1, dtype=torch.bool)
        j0 = 0
        while int(p[j0]) != 0:
            used[j0] = True
            i0 = int(p[j0])
            cur = a[i0 - 1, :] - u[i0] - v[1:]
            cols_used = used[1:]
            better = (~cols_used) & (cur < minv[1:])
            minv[1:] = torch.where(better, cur, minv[1:])
            way[1:] = torch.where(better, torch.tensor(j0, dtype=torch.int32), way[1:])
            mv = torch.where(cols_used, INF, minv[1:])
            j1 = int(torch.argmin(mv)) + 1
            delta = mv[j1 - 1]
            cnt = (used[None, :] & (p[None, :] == rrows[:, None])).to(torch.float32).sum(1)
            u = u + delta * cnt
            v = v - torch.where(used, delta, torch.zeros((), dtype=torch.float32))
            minv = minv - torch.where(used, torch.zeros((), dtype=torch.float32), delta)
            j0 = j1
        while j0 != 0:
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    return p


def _hungarian_slow(cost: torch.Tensor) -> torch.Tensor:
    """Exact LSA row-for-column on a (T, D) CPU matrix with BIG invalids."""
    T, D = cost.shape
    n = max(T, D)
    # finite cap > (n+1) * max valid cost: maximize real matches first,
    # then minimize their sum, with potentials small enough for float32
    valid = cost < BIG / 2
    maxv = torch.where(valid, cost, torch.zeros((), dtype=torch.float32)).max()
    cap = maxv * (n + 1) + 1.0
    c = torch.where(valid, cost, cap)
    if T <= D:
        return _hungarian_rect(c)[1:D + 1] - 1
    det_for_track = _hungarian_rect(c.T.contiguous())[1:T + 1] - 1
    eq = (det_for_track[None, :] == torch.arange(D)[:, None]) & (det_for_track[None, :] >= 0)
    has = eq.any(1)
    row = torch.argmax(eq.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(has, row, torch.tensor(-1, dtype=torch.int32))


def hungarian_assign(cost: torch.Tensor, max_dist) -> torch.Tensor:
    """cost: (T, D) with BIG at invalid pairs. Returns (D,) int32
    row-for-column (-1 where unmatched or gated by max_dist)."""
    T, D = cost.shape
    dev = cost.device
    colmin = cost.min(dim=0).values
    amin = torch.argmin(cost, dim=0).to(torch.int32)  # first minimum
    validc = colmin < float(BIG / 2)
    strict = (cost == colmin[None, :]).to(torch.int32).sum(0) == 1
    same = (amin[:, None] == amin[None, :]) & validc[:, None] & validc[None, :]
    distinct = same.to(torch.int32).sum(1) == 1
    fast_ok = torch.all(torch.where(validc, strict & distinct, True)) & (
        validc.to(torch.int32).sum() <= T
    )
    if bool(fast_ok):
        row_for_col = amin
    else:
        row_for_col = _hungarian_slow(cost.cpu()).to(dev)
    picked = cost[row_for_col.clamp(0, T - 1).long(), torch.arange(D, device=dev)]
    ok = (
        (row_for_col >= 0) & (row_for_col < T) & (picked < float(BIG / 2))
        & (picked <= float(np.float32(max_dist)))
    )
    return torch.where(ok, row_for_col, -1).to(torch.int32)
