"""P4's register layout (csrc/probes.cu namespace cell) modelled on the CPU.

The kernel holds the (80, 512) int32 tile in the registers of 1024
threads: thread (w, l), l = 8 cb + rb, holds the block of rows 10 rb ..
10 rb + 9 and columns 16 w + 4 cb .. + 3 (``cell_probe.BLOCK``), so a warp
holds 16 whole columns. The model keeps the tile as those blocks, shape
(warps, column groups, row blocks, rows, columns), and moves only what
the kernel moves between threads: an axis-0 step the edge row of the lane
above or below in the column group (a shuffle of width 8: row 79 wraps to
row 0 inside the warp), an axis-1 step the edge column of the lane one
column group over (``__shfl_up_sync`` / ``__shfl_down_sync`` by 8 lanes,
which give the first or last column group its own word) and, at the
warp's edge column groups, the neighbouring warp's edge column through
the double-buffered shared slots (warp 0 reads warp 31's: the wrap).
Every case joined back equals ``cell_probe.plain`` bit for bit at
``CHECK_REPS``; leaving out the warp-edge exchange, or reading the other
buffer, makes it differ.
"""

import pytest
import torch

from tpuva_torch.probes import case_index, cell_probe as cp
from test_torch_kernels import one_torch_thread  # noqa: F401

R, C = cp.BLOCK
RB, CG, WARPS = cp.ROW_BLOCKS, cp.COL_GROUPS, cp.WARPS
FAULTS = (None, "no warp-edge exchange", "the other buffer")


def to_blocks(x: torch.Tensor) -> torch.Tensor:
    """(80, 512) -> (warp, column group, row block, rows, columns)."""
    return x.reshape(RB, R, WARPS, CG, C).permute(2, 3, 0, 1, 4).contiguous()


def from_blocks(b: torch.Tensor) -> torch.Tensor:
    return b.permute(2, 3, 0, 1, 4).reshape(cp.SH, cp.SW)


class Block:
    """The threads' blocks and the shared slots of the warp-edge columns."""

    def __init__(self, fault=None):
        self.fault = fault
        # [buffer][warp][row block][row], the kernel's Smem (its 16-byte
        # padding left out); nothing written yet
        self.slots = torch.full((2, WARPS, RB, R), -1, dtype=torch.int32)
        self.buf = 0

    @staticmethod
    def vstep(b, up, stride=1, first=0):
        """An axis-0 roll by one row + min on the plane of rows first,
        first + stride, ... of each block: the other rows stay, the edge
        row crosses from the lane above (up) or below in the column group."""
        p = b[:, :, :, first::stride]
        if up:
            edge = torch.roll(p[:, :, :, -1], 1, dims=2)  # row block rb - 1, 8 lanes wrapping
            moved = torch.cat([edge[:, :, :, None], p[:, :, :, :-1]], dim=3)
        else:
            edge = torch.roll(p[:, :, :, 0], -1, dims=2)
            moved = torch.cat([p[:, :, :, 1:], edge[:, :, :, None]], dim=3)
        b[:, :, :, first::stride] = torch.minimum(p, moved)

    def hstep(self, b, left):
        """An axis-1 roll by one column + min: the edge column of the next
        column group by a shuffle inside the warp; at the warp's edges the
        neighbouring warp's through the shared slots, after the barrier."""
        nr = b.shape[3]
        out_cg, out_col = (CG - 1, C - 1) if left else (0, 0)
        self.slots[self.buf, :, :, :nr] = b[:, out_cg, :, :, out_col]  # the writing lanes
        # the shuffle by 8 lanes: column group cg - 1 (left) or cg + 1; the
        # first (last) group gets its own word
        col = b[..., C - 1] if left else b[..., 0]
        a = col.clone()
        if left:
            a[:, 1:] = col[:, :-1]
        else:
            a[:, :-1] = col[:, 1:]
        if self.fault != "no warp-edge exchange":
            buf = self.buf ^ 1 if self.fault == "the other buffer" else self.buf
            shared = torch.roll(self.slots[buf, :, :, :nr], 1 if left else -1, dims=0)
            a[:, 0 if left else CG - 1] = shared
        if left:
            moved = torch.cat([a[..., None], b[..., :-1]], dim=4)
        else:
            moved = torch.cat([b[..., 1:], a[..., None]], dim=4)
        b.copy_(torch.minimum(b, moved))
        self.buf ^= 1

    def sweep(self, b):
        self.vstep(b, True)
        self.vstep(b, False)
        self.hstep(b, True)
        self.hstep(b, False)

    def rep(self, case, b):
        """One rep of case on the blocks, in place, as the kernel's loops."""
        if case == "baseline_min":
            for _ in range(8):
                self.vstep(b, True)
        elif case == "extract_roundtrip":
            for _ in range(4):
                self.vstep(b, True, 2, 0)
                self.vstep(b, True, 2, 1)
        elif case == "baseline_sweepish":
            for _ in range(16):
                self.sweep(b)
        else:  # the 2-row cells inside a thread: 5 cell rows a block
            bottom = b[:, :, :, 1::2].clone()
            v = torch.minimum(b[:, :, :, 0::2], bottom)
            for _ in range(16):
                self.sweep(v)
            b[:, :, :, 0::2] = v
            b[:, :, :, 1::2] = torch.maximum(v, bottom)


def model(x, case, reps, fault=None):
    """`reps` reps of case on the (80, 512) tile as the kernel's threads run
    them; the tile joined back."""
    case_index(cp.CASES, case)
    b, state = to_blocks(x.clone()), Block(fault)
    for _ in range(reps):
        state.rep(case, b)
    return from_blocks(b)


def test_layout_is_whole_columns_a_warp():
    assert RB * CG == 32 and WARPS * 32 == 1024 and R * C == 40 and R % 2 == 0
    x = torch.arange(cp.SH * cp.SW, dtype=torch.int32).reshape(cp.SH, cp.SW)
    b = to_blocks(x)
    assert torch.equal(from_blocks(b), x)
    rows, cols = b // cp.SW, b % cp.SW
    for w in (0, 7, WARPS - 1):  # a warp: 16 whole columns, all 80 rows
        assert sorted(set(cols[w].flatten().tolist())) == list(range(16 * w, 16 * w + 16))
        assert sorted(set(rows[w].flatten().tolist())) == list(range(cp.SH))
    # thread (w, cg, rb): rows 10 rb .., columns 16 w + 4 cg ..
    assert int(b[3, 2, 5, 0, 0]) == (10 * 5) * cp.SW + 16 * 3 + 4 * 2


@pytest.mark.parametrize("case", [c.name for c in cp.CASES])
def test_register_blocks_match_plain(case):
    x = cp.make_tile()
    for reps in cp.CHECK_REPS:
        assert torch.equal(model(x, case, reps), cp.plain(x, case, reps)), f"{case} at {reps} reps"


@pytest.mark.parametrize("fault", FAULTS[1:])
@pytest.mark.parametrize("case", ["baseline_sweepish", "cell_sweepish"])
def test_a_skipped_warp_edge_exchange_differs(case, fault):
    """The warp-edge exchange and its buffer are needed: without them the
    model leaves plain at the first rep."""
    x = cp.make_tile()
    assert not torch.equal(model(x, case, 1, fault), cp.plain(x, case, 1))
