"""Kernel K1's plain version (tpuva_torch.ops.fused_segment) against the
Pallas kernel tpuva.ops.pallas.fused_segment, run in interpret mode as
tests/test_pallas_fused.py runs it, on the same numpy frames.

Masks are compared bit for bit. The final background is compared bit for
bit against the pinned contract: float32 (1-a)*B + a*F with two products
and one add (refimpl/pipeline.py's numpy form), over the reference's own
filtered frames. Against the JAX result it is held to 1e-5 relative: the
XLA:CPU backend contracts that update into a fused multiply-add inside
its frame loop (fma(1-a, B, a*F), one rounding instead of two), a few
float32 ulps from the contract.

The CUDA kernel has no CPU mode: tests/test_torch_kernels.py holds it
against this plain version on a card, and chip_smoke.py at the main
path's shapes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuva.graph.config import BlurConfig, MedianConfig, PipelineConfig
from tpuva.graph.pipeline import filter_batch
from tpuva.ops.pallas.fused_segment import fused_segment as jax_fused, fused_tile as jax_fused_tile
from tpuva_torch.ops.fused_segment import (
    MAX_TAPS,
    SMEM_LIMIT,
    SMS,
    THREADS,
    TILES,
    UNROLLED_TAPS,
    _fused_segment_cuda,
    bg_regs_kind,
    fused_segment,
    fused_segment_plain,
    fused_segment_plan,
    fused_tile,
    k1_split,
    launch_plan,
    modelled_blocks_per_sm,
    run_split,
    smem_bytes,
)
from tpuva_torch.ops.filters import structuring_element
from tpuva_torch.ops.wide import blur_u8, morph_u8, occ128_plain, se_runs
from test_torch_kernels import BENCH, CONFIGS, one_torch_thread, scene  # noqa: F401


def contract_bg(filtered, bg0, alpha):
    """The pinned float32 recurrence, two roundings per step."""
    a = np.float32(alpha)
    c1 = np.float32(1) - a
    bg = bg0.astype(np.float32)
    for f in filtered:
        bg = c1 * bg + a * f
    return bg


def _jax_filtered(frames, kw):
    cfg = PipelineConfig(
        blur=BlurConfig(kw["blur_ksize"], kw["blur_sigma"]),
        median=MedianConfig(3) if kw.get("median_ksize") else None,
    )
    return np.asarray(filter_batch(cfg, jnp.asarray(frames, jnp.float32)))


@pytest.mark.parametrize("shape", [(5, 64, 256), (4, 50, 100)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_matches_pallas(name, shape):
    kw = CONFIGS[name]
    frames, bg0 = scene(*shape, seed=sum(shape))
    m_ref, bg_ref = jax_fused(jnp.asarray(frames), jnp.asarray(bg0), **kw)
    masks, bg = fused_segment(torch.from_numpy(frames), torch.from_numpy(bg0), **kw)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(m_ref))
    assert masks.numpy().any()
    filtered = _jax_filtered(frames, kw)
    np.testing.assert_array_equal(bg.numpy(), contract_bg(filtered, bg0, kw["alpha"]))
    np.testing.assert_allclose(bg.numpy(), np.asarray(bg_ref), rtol=1e-5)


@pytest.mark.parametrize("name", ["bench", "median3"])
def test_seed_bg_from_filtered_first_frame(name):
    """seed_bg starts from the filtered first frame, as tpuva's
    _fused_mask_stage seeds bg0 = filter_batch(frames[:1])[0]."""
    kw = CONFIGS[name]
    frames, _ = scene(5, 64, 256, seed=3)
    filtered = _jax_filtered(frames, kw)
    m_ref, _ = jax_fused(jnp.asarray(frames), jnp.asarray(filtered[0]), **kw)
    masks, bg = fused_segment(
        torch.from_numpy(frames), torch.zeros(64, 256), seed_bg=True, **kw
    )
    np.testing.assert_array_equal(masks.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(
        bg.numpy(), contract_bg(filtered, filtered[0], kw["alpha"])
    )


def test_no_blur_no_morph_and_empty_batch():
    kw = dict(alpha=0.1, threshold=10.0)
    frames, bg0 = scene(3, 40, 70, seed=9)
    m_ref, _ = jax_fused(jnp.asarray(frames), jnp.asarray(bg0), **kw)
    masks, _ = fused_segment(torch.from_numpy(frames), torch.from_numpy(bg0), **kw)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(m_ref))
    m0, b0 = fused_segment(
        torch.zeros((0, 40, 70), dtype=torch.uint8), torch.from_numpy(bg0), **kw
    )
    assert m0.shape == (0, 40, 70)
    np.testing.assert_array_equal(b0.numpy(), bg0)


# padded_occ cases: tests/test_pallas_fused.py's (6, 120, 200) scene and
# config, a median-3 config on a ragged shape, and an empty batch
PADDED_CASES = {
    "moving_disk_120x200": ((6, 120, 200), dict(alpha=0.05, threshold=35.0, blur_ksize=5,
                                                blur_sigma=0.0, open_ksize=3,
                                                open_shape="rect")),
    "median3_50x100": ((4, 50, 100), CONFIGS["median3"]),
    "empty_batch": ((0, 40, 70), BENCH),
}


@pytest.mark.parametrize("name", sorted(PADDED_CASES))
def test_padded_occ_matches_pallas(name):
    """fused_segment(padded_occ=True) against tpuva's Pallas kernel in
    interpret mode: the padded mask (zero outside the image) and occ128
    bit-equal, both shaped by fused_tile; the background bit-equal to the
    port's cropped emit (and so to the two-rounding contract) and within
    1e-5 of tpuva's FMA-contracted one (R1, as above); the cropped mask
    equal to the cropped emit."""
    shape, kw = PADDED_CASES[name]
    if name == "moving_disk_120x200":
        from refimpl.synthetic import moving_disk_clip

        frames, _, plate = moving_disk_clip(h=120, w=200, frames=6, radius=9,
                                            noise_sigma=4.0, seed=13)
        bg0 = plate.astype(np.float32)
    else:
        frames, bg0 = scene(max(shape[0], 1), *shape[1:], seed=4)
        frames = frames[:shape[0]]
    N, H, W = shape
    Hp, Wp = fused_tile(H, W)[2:]
    m_ref, bg_ref, occ_ref = jax_fused(jnp.asarray(frames), jnp.asarray(bg0), padded_occ=True,
                                       **kw)
    m, bg, occ = fused_segment(torch.from_numpy(frames), torch.from_numpy(bg0),
                               padded_occ=True, **kw)
    assert m.shape == (N, Hp, Wp) and occ.shape == (N, Hp // 2, Wp // 128)
    assert occ.dtype == torch.uint8
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    assert not m[:, H:].any() and not m[:, :, W:].any()
    np.testing.assert_array_equal(occ.numpy(), occ128_plain(m).numpy())
    crop, bg_crop = fused_segment(torch.from_numpy(frames), torch.from_numpy(bg0), **kw)
    assert torch.equal(m[:, :H, :W], crop) and torch.equal(bg, bg_crop)
    np.testing.assert_allclose(bg.numpy(), np.asarray(bg_ref), rtol=1e-5)
    if N:
        assert occ.any() and not occ.all()


def test_fused_tile_copy_matches_original():
    for H in (1, 2, 31, 32, 33, 96, 97, 120, 128, 129, 192, 250, 1080, 2160):
        for W in (1, 5, 127, 128, 129, 200, 256, 333, 1000, 1024, 1025, 1920, 3840):
            assert fused_tile(H, W) == jax_fused_tile(H, W), (H, W)


def test_padded_occ_refuses_the_diff_emit():
    frames = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="occupancy"):
        fused_segment(frames, torch.zeros(8, 8), alpha=0.1, threshold=0.0, emit="diff",
                      padded_occ=True)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    frames = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fused_segment(frames.float(), torch.zeros(8, 8), **BENCH)
    with pytest.raises(ValueError):
        fused_segment(frames, torch.zeros(8, 9), **BENCH)
    with pytest.raises(NotImplementedError):
        fused_segment(frames, torch.zeros(8, 8), median_ksize=5, **BENCH)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        fused_segment(frames.to("meta"), torch.zeros(8, 8, device="meta"), **BENCH)
    # one launch refuses what k1_takes refuses, before it touches a card
    for wide in (dict(blur_ksize=65), dict(close_ksize=33), dict(open_ksize=7, open_iters=10,
                                                                  close_ksize=7, close_iters=10)):
        with pytest.raises(ValueError, match="k1_takes"):
            _fused_segment_cuda(frames, torch.zeros(8, 8), **dict(BENCH, **wide))
    for op in (lambda x: blur_u8(x, 65), lambda x: morph_u8(x, np.ones((3, 3), bool), True)):
        with pytest.raises(ValueError):
            op(frames.float())
        with pytest.raises(ValueError):
            op(frames.to("meta"))


# options one K1 launch does not take, with the stages k1_split takes out
# of it at 1080p, and two it takes whole
SPLIT_CONFIGS = {
    "bench": (BENCH, (False, False)),
    "reach120": (dict(BENCH, open_ksize=7, open_iters=10, close_ksize=7, close_iters=10),
                 (False, True)),
    "se33_median3": (dict(BENCH, median_ksize=3, close_shape="ellipse", close_ksize=33),
                     (False, True)),
    "blur65": (dict(BENCH, blur_ksize=65), (True, False)),
    "blur65_se33": (dict(BENCH, blur_ksize=65, close_ksize=33), (True, True)),
    "blur65_diff": (dict(alpha=0.02, threshold=0.0, blur_ksize=65, median_ksize=3,
                         emit="diff"), (True, False)),
}


@pytest.mark.parametrize("parts", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("name", sorted(SPLIT_CONFIGS))
def test_split_matches_one_pass(name, parts):
    """run_split, the form fused_segment takes on the card (blur_u8 before
    K1, open_close_u8 after it, K1 on the stages that stay), with the plain
    versions in place of the kernels: masks and background bit-equal to
    one pass over every option, for every split, seeded from the first
    frame or from bg0. k1_split picks the split the table says."""
    kw, split = SPLIT_CONFIGS[name]
    assert k1_split(1080, 1920, **kw) == split
    full = dict(blur_ksize=0, blur_sigma=0.0, median_ksize=0, open_shape="rect", open_ksize=0,
                open_iters=1, close_shape="rect", close_ksize=0, close_iters=1, emit="mask")
    full.update(kw)
    frames, bg0 = scene(4, 100, 160, seed=11)
    frames[1:, 10:95, 20:140] = 220  # a patch wider than reach120's erosion
    frames, bg0 = torch.from_numpy(frames), torch.from_numpy(bg0)
    for seed_bg in (False, True):
        ref = fused_segment_plain(frames, bg0, seed_bg=seed_bg, **full)
        got = run_split(frames, bg0, parts, fused_segment_plain, seed_bg=seed_bg, **full)
        for r, g in zip(ref, got):
            assert torch.equal(r, g), (name, parts, seed_bg)
    assert ref[0].any()


@pytest.mark.parametrize("H, W", [(1080, 1920), (2160, 3840), (250, 333), (64, 256), (7, 5),
                                  (1, 1), (1, 333), (250, 1)])
def test_launch_plan_fits_every_accepted_config(H, W):
    """For every tap count, median and morphology reach the wrapper
    accepts: the plan picks an instantiation the kernel has, its grid
    covers the image with no empty row or column of CTAs, its shared
    memory stays within a CTA's and equals smem_bytes, and its waves
    follow from the occupancy; where it refuses, no tile fits."""
    for ntaps in range(1, MAX_TAPS + 1, 2):
        for median in (False, True):
            for reach in (0, 1, 2, 4, 8, 30, 60, 90, 120):
                try:
                    plan = launch_plan(H, W, ntaps, median, reach)
                except ValueError:
                    assert all(smem_bytes(th, tw, ntaps, median, reach) > SMEM_LIMIT
                               for th, tw in TILES)
                    continue
                assert plan.variant == (ntaps if ntaps in UNROLLED_TAPS else 0)
                assert plan.variant in (0, *UNROLLED_TAPS) and plan.tile in TILES
                th, tw = plan.tile
                assert tw in (32, 64, 128) and THREADS % (tw // 16) == 0
                gx, gy = plan.grid
                assert (gx - 1) * tw < W <= gx * tw and (gy - 1) * th < H <= gy * th
                assert plan.smem == smem_bytes(th, tw, ntaps, median, reach) <= SMEM_LIMIT
                bps = modelled_blocks_per_sm(ntaps, median, reach, th, tw, plan.smem)
                assert plan.blocks_per_sm == bps >= 1
                assert plan.waves == -(-(gx * gy) // (bps * SMS))
                kind = plan.bg_regs
                assert kind == bg_regs_kind(th, tw, reach) and kind in (0, 1, 2)
                cx, seg = -(-(tw + 2 * reach) // 32), -(-(th + 2 * reach) // 8)
                lim = {0: (cx, seg), 1: (2, 8), 2: (3, 5)}[kind]
                assert cx <= lim[0] and seg <= lim[1]


def test_launch_plan_follows_the_occupancy_it_is_given():
    """The plan weighs rounds x window area, with morphology at least two
    rounds. Bench config at 1080p: at 3 CTAs an SM (the card's, PERF.md)
    32 x 64 tiles in three waves, background in registers; at the
    shared-memory model's 8 CTAs an SM, 16 x 64 tiles in two waves; told
    that one CTA fits an SM, the largest tile, whose fewer waves outweigh
    its halo. Without morphology one wave counts as one round."""
    three = fused_segment_plan(1080, 1920, blocks_per_sm=lambda *a: 3, **BENCH)
    assert three.tile == (32, 64) and three.grid == (30, 34) and three.waves == 3
    assert three.variant == 5 and three.bg_regs == 2
    model = fused_segment_plan(1080, 1920, **BENCH)
    assert model.tile == (16, 64) and model.waves == 2 and model.blocks_per_sm == 8
    one = fused_segment_plan(1080, 1920, blocks_per_sm=lambda *a: 1, **BENCH)
    assert one.tile == (64, 128) and one.waves == 2 and one.bg_regs == 0
    diff = fused_segment_plan(1080, 1920, blur_ksize=5)
    assert diff.tile == (32, 64) and diff.waves == 1 and diff.bg_regs == 1
    diff3 = fused_segment_plan(1080, 1920, blur_ksize=5, blocks_per_sm=lambda *a: 3)
    assert diff3.tile == (32, 64) and diff3.waves == 3


def test_se_runs_cover_the_structuring_element():
    """K1m's form of an SE: its runs, laid back on a grid from the anchor,
    give the SE pixel for pixel; one run a row for cv2's rect and ellipse."""
    rng = np.random.default_rng(1)
    ses = [structuring_element(shape, k) for shape in ("rect", "ellipse") for k in (1, 3, 7, 33)]
    ses += [rng.random((k, k + 2)) < 0.4 for k in (1, 3, 5, 9)]
    for i, se in enumerate(ses):
        kh, kw = se.shape
        runs = np.array(se_runs(se), np.int64).reshape(-1, 3)
        grid = np.zeros_like(se)
        for dy, lo, hi in runs:
            assert lo <= hi and not grid[dy + kh // 2, lo + kw // 2:hi + kw // 2 + 1].any()
            grid[dy + kh // 2, lo + kw // 2:hi + kw // 2 + 1] = True
        np.testing.assert_array_equal(grid, se)
        if i < 8:
            assert len(runs) == (se.any(axis=1)).sum()


@pytest.mark.parametrize("parts", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("name", sorted(n for n in SPLIT_CONFIGS if n != "blur65_diff"))
def test_split_padded_occ_matches_one_pass(name, parts):
    """run_split with padded_occ, the form the card takes for the staged
    route's padded handoff: where the morphology leaves K1, the last K1m
    step writes the padded mask and occ128, so that they describe the final
    mask. Padded mask, background and occ128 bit-equal to one plain pass."""
    kw, _split = SPLIT_CONFIGS[name]
    full = dict(blur_ksize=0, blur_sigma=0.0, median_ksize=0, open_shape="rect", open_ksize=0,
                open_iters=1, close_shape="rect", close_ksize=0, close_iters=1, emit="mask")
    full.update(kw)
    frames, bg0 = scene(3, 100, 160, seed=11)
    frames[1:, 10:95, 20:140] = 220
    frames, bg0 = torch.from_numpy(frames), torch.from_numpy(bg0)
    ref = fused_segment_plain(frames, bg0, padded_occ=True, **full)
    got = run_split(frames, bg0, parts, fused_segment_plain, padded_occ=True, **full)
    assert ref[0].shape == (3, 128, 256) and ref[2].any()
    for r, g in zip(ref, got):
        assert torch.equal(r, g), (name, parts)
