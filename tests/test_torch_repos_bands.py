"""P1's column bands (csrc/probes.cu namespace repos) on the CPU.

The roll cases band the (152, 1920) tile by columns, 240 a CTA, so that
an axis-0 roll never leaves a CTA. Thread (g, c) of 17 row groups x 60
moves the 16-byte vector c of rows g + 17 k; ``repos_probe.column_band_map``
gives the rows and vectors it reads and the rows it writes for an amount
d, by the kernel's own byte arithmetic. Applied to every band, the map is
``torch.roll(f, d, 0)`` and ``np.roll(f, d, axis=0)`` for every d of the
dynamic case (0-151) and the static 26, and writes every word once; a rep
of it, + 1, gives ``repos_probe.plain`` at ``CHECK_REPS`` for the four
roll cases.
"""

import numpy as np
import pytest
import torch

from tpuva_torch.probes import case_index, f32_to_i32, low_bytes, repos_probe as rp
from test_torch_kernels import one_torch_thread  # noqa: F401

ROLLS = [c.name for c in rp.CASES if "roll" in c.name]


def band_roll(f: np.ndarray, d: int):
    """roll(f, d, axis=0) of the (152, 1920) tile as the kernel's column
    bands move it: each CTA's columns, each vector from the map's row and
    vector. Returns (the tile, how many times each word was written)."""
    src_row, src_vec, dst_row = rp.column_band_map(d)
    has = dst_row >= 0
    vec = np.broadcast_to(np.arange(rp.VECS), dst_row.shape)[has]
    out = np.zeros_like(f)
    written = np.zeros(f.shape, dtype=np.int64)
    for q in range(rp.CTAS):
        cols = slice(q * rp.BAND_COLS, (q + 1) * rp.BAND_COLS)
        band = f[:, cols].reshape(rp.RL, rp.VECS, 4)
        o = out[:, cols].reshape(rp.RL, rp.VECS, 4)  # views of out
        w = written[:, cols].reshape(rp.RL, rp.VECS, 4)
        o[dst_row[has], vec] = band[src_row[has], src_vec[has]]
        np.add.at(w, (dst_row[has], vec), 1)
    return out, written


def test_band_layout_covers_the_tile():
    assert rp.BAND_COLS * rp.CTAS == rp.CL and rp.VECS * 4 == rp.BAND_COLS
    assert rp.GROUPS * rp.VECS <= 1024  # one CTA's threads
    assert rp.GROUPS * (rp.GROUP_ROWS - 1) < rp.RL <= rp.GROUPS * rp.GROUP_ROWS
    assert rp.RL * rp.ROW_BYTES <= 232448  # one CTA's shared memory on the H100
    assert max(rp.CHECK_REPS) > rp.RL  # the dynamic amount r % 152 takes every value


def test_band_map_is_the_roll_for_every_amount():
    f = np.random.default_rng(3).integers(0, 1 << 20, (rp.RL, rp.CL), dtype=np.int32)
    for d in list(range(rp.RL)) + [26]:
        src_row, src_vec, dst_row = rp.column_band_map(d)
        has = dst_row >= 0
        assert (src_vec[has] == np.broadcast_to(np.arange(rp.VECS), has.shape)[has]).all(), d
        assert ((src_row[has] - dst_row[has] + d) % rp.RL == 0).all(), d
        got, written = band_roll(f, d)
        assert (written == 1).all(), f"d = {d}: a word is written {written.max()} times or none"
        np.testing.assert_array_equal(got, np.roll(f, d, axis=0), err_msg=f"d = {d}")
        assert torch.equal(torch.from_numpy(got), torch.roll(torch.from_numpy(f), d, 0)), d


@pytest.mark.parametrize("case", ROLLS)
def test_band_reps_match_plain(case):
    """`reps` reps of the case as the kernel runs them (each rep the map's
    roll, then + 1, in int32 or float32) equal plain at CHECK_REPS."""
    i = case_index(rp.CASES, case)
    x = rp.make_tile()
    for reps in rp.CHECK_REPS:
        f = x.numpy().astype(np.float32 if i in rp.FLOAT_CASES else np.int32)
        for r in range(reps):
            f, _ = band_roll(f, r % rp.RL if i == 2 else 26)
            f = f + f.dtype.type(1)
        t = torch.from_numpy(f)
        got = low_bytes(f32_to_i32(t) if i in rp.FLOAT_CASES else t)
        assert torch.equal(got, rp.plain(x, case, reps)), f"{case} at {reps} reps"
