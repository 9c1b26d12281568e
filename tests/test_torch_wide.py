"""K1b's and K1m's plans (tpuva_torch.ops.wide) and the grouped
morphology's plain path against tpuva's morph_open / morph_close.

morph_plan cuts a step list into the groups K1m runs one launch each, and
blur_plan picks K1b's tile and instantiation; both are pure functions of
the shapes, so their invariants are checked here without a card. On CPU
tensors open_close_u8 and morph_steps walk the same groups with the plain
_morph, so every cut of the plan is held to tpuva's result bit for bit.
The kernels themselves are held to these plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuva.ops.filters as jf
from tpuva_torch.ops.filters import blur_taps, structuring_element
from tpuva_torch.ops.fused_segment import k1_split
from tpuva_torch.ops.wide import (
    BLUR_TILE_HS,
    BLUR_TILE_W,
    MORPH_HALO,
    MORPH_TILES,
    SMEM_LIMIT,
    blur_plan,
    blur_smem,
    morph_plan,
    morph_smem,
    morph_step,
    morph_steps,
    open_close_steps,
    open_close_u8,
)
from test_torch_kernels import BENCH, one_torch_thread  # noqa: F401


def _random_se(kh, kw, seed, anchor=True):
    se = np.random.default_rng(seed).random((kh, kw)) < 0.45
    se[kh // 2, kw // 2] = anchor
    return se


def _steps(se, n_open, n_close):
    return ([(se, True)] * n_open + [(se, False)] * n_open + [(se, False)] * n_close
            + [(se, True)] * n_close)


# step lists: open and close 7 x 10 (reach 120) and 5 x 10 (reach 80), the
# se33 config's open 3 and close 33, 45-wide steps, a random SE with
# several runs a row (no anchor), and a run no tile's buffers hold
PLAN_CASES = {
    "reach120": open_close_steps((("rect", 7, 10), ("rect", 7, 10))),
    "reach80": open_close_steps((("rect", 5, 10), ("rect", 5, 10))),
    "se33": open_close_steps((("rect", 3, 1), ("ellipse", 33, 1))),
    "ksize45": [(structuring_element("rect", 45), True), (structuring_element("ellipse", 45), False)],
    "ellipse7x4": open_close_steps((("ellipse", 7, 4), ("ellipse", 7, 4))),
    "random": _steps(_random_se(9, 11, 3, anchor=False), 3, 2),
    "past_every_tile": [(np.ones((1, 8001), bool), True), (structuring_element("rect", 3), False)],
}


def _table_pixels(table):
    """The SE pixels (dy, dx) one step's table describes, its head and the
    rest of the table."""
    erode, ry, rx, ne = table[:4]
    pos, pix = 4, set()
    for _ in range(ne):
        lo, hi, nv = table[pos:pos + 3]
        for v in range(nv):
            a, b = table[pos + 3 + 2 * v:pos + 5 + 2 * v]
            assert a <= b
            pix |= {(dy, dx) for dy in range(a, b + 1) for dx in range(lo, hi + 1)}
        pos += 3 + 2 * nv
    return (erode, ry, rx), pix, table[pos:]


@pytest.mark.parametrize("H, W", [(1080, 1920), (100, 160), (7, 5), (1, 333)])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_morph_plan_covers_every_step_in_order(name, H, W):
    """The groups cover the steps once each, in order; a group's reach is
    its steps' summed reach, its region (tile plus halo) fits shared memory
    and, past one step, MORPH_HALO times the tile; its table is its steps'
    tables, each the SE pixel for pixel; the one-step global kernel only
    where no tile takes the step. Reach 120 takes at most 8 launches."""
    steps = PLAN_CASES[name]
    plan = morph_plan(H, W, steps)
    assert plan[0].start == 0 and plan[-1].stop == len(steps)
    assert all(a.stop == b.start for a, b in zip(plan, plan[1:]))
    for g in plan:
        infos = [morph_step(se, erode) for se, erode in steps[g.start:g.stop]]
        assert g.reach == (sum(s.ry for s in infos), sum(s.rx for s in infos))
        assert g.skip == all(s.anchor for s in infos)
        if g.kernel == "step":
            assert g.stop - g.start == 1
            assert all(morph_smem(th, tw, *g.reach, 2 if infos[0].extents == 1 else 3,
                                  len(infos[0].table)) > SMEM_LIMIT for th, tw in MORPH_TILES)
            assert g.table == infos[0].runs
            continue
        th, tw = g.tile
        assert g.tile in MORPH_TILES and g.grid == (-(-W // tw), -(-H // th))
        assert g.nbuf == (3 if any(s.extents > 1 for s in infos) else 2)
        assert g.smem == morph_smem(th, tw, *g.reach, g.nbuf, len(g.table)) <= SMEM_LIMIT
        Rxa = -(-g.reach[1] // 16) * 16
        assert (g.stop - g.start == 1
                or (th + 2 * g.reach[0]) * (tw + 2 * Rxa) <= MORPH_HALO * th * tw)
        rest = g.table
        for (se, erode), s in zip(steps[g.start:g.stop], infos):
            head, pix, rest = _table_pixels(rest)
            kh, kw = se.shape
            assert head == (int(erode), s.ry, s.rx)
            assert pix == {(dy - kh // 2, dx - kw // 2) for dy, dx in zip(*np.nonzero(se))}
        assert rest == ()
    if name == "reach120":
        assert len(plan) <= 8
    assert [g.kernel for g in plan].count("step") == (1 if name == "past_every_tile" else 0)


def test_morph_plan_launches_of_the_split_configs():
    """The K1m launches a call of the configs one K1 launch does not take
    (tests/test_torch_kernels.py's SPLIT_CONFIGS, chip_smoke.py phase 5c):
    open and close 7 x 10 in 4 launches (10 steps, reach 30, a launch), 5 x
    10 in 3, the 33-wide close with the open 3 in 2."""
    for H, W in ((100, 160), (160, 240), (1080, 1920)):
        assert len(morph_plan(H, W, PLAN_CASES["reach120"])) == 4
        assert len(morph_plan(H, W, PLAN_CASES["reach80"])) == 3
        assert len(morph_plan(H, W, PLAN_CASES["se33"])) == 2
        assert len(morph_plan(H, W, open_close_steps((("rect", 3, 1), ("rect", 33, 1))))) == 2


@pytest.mark.parametrize("H, W", [(1080, 1920), (250, 333), (7, 5), (1, 1)])
def test_blur_plan_fits_every_tap_count(H, W):
    """3 to 255 taps (and past them): the tiled launch's shared memory is
    blur_smem's and fits a CTA, on the tallest tile that leaves an SM room
    for a second CTA, else the tallest that fits; "global" only where no
    tile's window fits; __dp4a and __dp2a_lo only where every tap is at
    most 255. At 65 taps (the blur65 config) 128 x 64."""
    for ntaps in list(range(3, 257, 2)) + [301, 501, 1001]:
        for taps in ((1,) * ntaps, (0,) * (ntaps // 2) + (256,) + (0,) * (ntaps // 2)):
            plan = blur_plan(H, W, taps)
            smem = {th: blur_smem(th, BLUR_TILE_W, ntaps) for th in BLUR_TILE_HS}
            assert plan.dp == (max(taps) <= 255)
            if plan.kernel == "global":
                assert min(smem.values()) > SMEM_LIMIT and ntaps > 255
                continue
            th, tw = plan.tile
            assert tw == BLUR_TILE_W and th % 8 == 0 and tw % 16 == 0
            assert plan.smem == smem[th] <= SMEM_LIMIT
            two = [t for t in BLUR_TILE_HS if 2 * (smem[t] + 1024) <= 228 * 1024]
            assert th == (two[0] if two else max(t for t in BLUR_TILE_HS if smem[t] <= SMEM_LIMIT))
            assert plan.grid == (-(-W // tw), -(-H // th))
    assert blur_plan(1080, 1920, blur_taps(65)[0]).tile == (128, 64)


def test_blur_taps_of_every_route():
    """Every blur the route can hand K1b (k1_split takes the blur out of K1
    past 63 taps): cv2's taps are symmetric, their row sums fit 16 bits,
    and at sigma 0 (the configs' default, blur65) or from 0.8 up each tap
    is at most 255, so the plan takes __dp4a and __dp2a_lo; a sigma of 0.1
    makes a centre tap of 256, a multiply-add a tap."""
    for ksize in range(3, 257, 2):
        for sigma in (0.0, 0.1, 0.8, 1.5, 4.0, 30.0):
            taps, shift = blur_taps(ksize, sigma)
            assert taps == taps[::-1] and sum(taps) * 255 <= 0xFFFF and shift >= 1
            assert blur_plan(1080, 1920, taps).dp == (sigma != 0.1)
            if ksize > 63:
                assert k1_split(1080, 1920, **dict(BENCH, blur_ksize=ksize, blur_sigma=sigma))[0]


SES = {"rect": structuring_element("rect", 7), "ellipse": structuring_element("ellipse", 7),
       "random": _random_se(5, 7, 11)}


def _masks(H, W, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((2, H, W)) < 0.15).astype(np.uint8) * 255
    m[:, H // 4:3 * H // 4 + 1, W // 5:4 * W // 5 + 1] = 255  # a block wider than the SE
    return m


@pytest.mark.parametrize("H, W", [(37, 301), (7, 5)])
@pytest.mark.parametrize("iters", range(1, 11))
@pytest.mark.parametrize("se_name", sorted(SES))
def test_grouped_open_close_matches_tpuva(se_name, iters, H, W):
    """open_close_u8's grouped plain path (each morph_plan group as _morph
    steps) equals tpuva's morph_open then morph_close with the same
    iterations, bit for bit, and so does morph_steps for the open alone;
    images shorter and narrower than a group's halo."""
    se = SES[se_name]
    x = _masks(H, W, seed=iters)
    ref_open = jf.morph_open(jnp.asarray(x), se, iters)
    ref = np.asarray(jf.morph_close(ref_open, se, iters))
    if se_name == "random":  # open_close_u8 takes cv2's shapes; the steps directly
        got = morph_steps(torch.from_numpy(x), _steps(se, iters, iters))
    else:
        got = open_close_u8(torch.from_numpy(x), ((se_name, 7, iters), (se_name, 7, iters)))
    np.testing.assert_array_equal(got.numpy(), ref)
    got_open = morph_steps(torch.from_numpy(x), _steps(se, iters, 0))
    np.testing.assert_array_equal(got_open.numpy(), np.asarray(ref_open))
    assert len(morph_plan(H, W, _steps(se, iters, iters))) < 4 * iters
