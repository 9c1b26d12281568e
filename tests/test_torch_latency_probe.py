"""The latency probe (``tpuva_torch.probes.latency_probe``) on the CPU: its
plain version, the output its kernel is held to on the card. It replaces
no TPU probe, so there is no JAX side: the chase follows the tile's
permutation, which is one cycle through all 1024 indices; the float
chains give their closed forms; CPU calls launch nothing."""

import numpy as np
import pytest
import torch

from tpuva_torch.probes import latency_probe as lp
from test_torch_kernels import one_torch_thread  # noqa: F401


def test_tile_is_one_cycle():
    x = lp.make_tile().numpy()
    seen, j = set(), 0
    for _ in range(lp.N):
        seen.add(j)
        j = int(x[j])
    assert j == 0 and len(seen) == lp.N


@pytest.mark.parametrize("case", [c.name for c in lp.CASES])
@pytest.mark.parametrize("reps", lp.CHECK_REPS)
def test_plain_chains(case, reps):
    x = lp.make_tile()
    before = lp.run.launches
    out = lp.run(x, case, reps)
    assert lp.run.launches == before
    assert out.dtype == torch.int32 and torch.equal(out[1:], x[1:])
    x0, v = int(x[0]), int(out[0])
    if case in ("f32 add", "cast-hop f->i->f + 1"):
        f = np.float32(x0)
        for _ in range(reps):
            f = np.float32(f + np.float32(1.0))
        assert np.int32(v).view(np.float32) == f
    elif case.endswith("load"):
        j = 0
        for _ in range(reps):
            j = int(x[j])
        assert v == j
    elif case in ("i32 add", "packed add (int16)"):
        assert np.int32(v).view(np.uint32) == add_loop(x, reps, case != "i32 add")
    else:
        assert v == reps


def add_loop(x, reps, packed):
    """The add chains a sum at a time: the xor of v_0 = x[0] and every v_j =
    v_(j-1) + w, w = x[1] | x[2] << 16 (packed: each halfword wrapped)."""
    u, w = int(x[0]), int(x[1]) | int(x[2]) << 16
    out = u
    for _ in range(reps):
        if packed:
            u = ((u + w) & 0xFFFF) | (((u >> 16) + (w >> 16)) & 0xFFFF) << 16
        else:
            u = (u + w) & 0xFFFFFFFF
        out ^= u
    return out


def test_packed_add_wraps_each_halfword():
    """At 1000 reps the low halfword's sum passes 2^16: a plain 32-bit add
    would carry into the high half, the packed add does not."""
    x = lp.make_tile()
    assert int(x[0]) + 1000 * int(x[1]) >= 1 << 16
    assert not torch.equal(lp.run(x, "packed add (int16)", 1000), lp.run(x, "i32 add", 1000))
