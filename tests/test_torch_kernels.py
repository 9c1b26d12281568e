"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so it runs where the card is (the tests/
conftest.py imports JAX, so skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu -q

Without a CUDA device every test here skips: a CUDA kernel has no CPU
mode. Kernel and plain version are compared bit for bit (masks, float32
background, every stats field, dense labels): both are the same integer
and IEEE float32 operation sequences. K1's emit="diff" (rounded
magnitudes, rint half to even) and the histogram kernel K4 (integer
counts) likewise, and the tracker scan K5 (rows and every state tensor,
float bits included). K1's stages past shared memory (K1b blur_u8, K1m
morph_u8) and the split fused_segment runs with them likewise, and K1's
padded_occ emit (padded mask, zero padding, occ128) with and without the
split. K2 given the strip occupancy against K2 deriving it and against
its plain version, on sparse, dense and empty masks. K3's occupancy skip
on masks with one occupied strip at each ragged edge, 4-connected on the
segment-skip scenes at N = 1 and 256, with the occupancy it hands K6. K6
(root_stats and root_stats_dict, the dense stats and the stats dict) at
every option, given K3's occupancy and deriving it, in shared and in
global memory, one kernel launch a call (torch.profiler). Also
the micro-probes' kernels (tpuva_torch.probes, csrc/probes.cu) bit for
bit on every case at the probe's tile shape, and their time grows with
the reps. Also BatchStager's pinned-buffer copies to the card, byte for byte, from
both feeders (a slow consumer at queue depth 1 included), the streamed route fed by
the C++ ring, and configs
one K1 launch does not take run on the card with the CPU's rows. The filter
chain (tpuva_torch.filters) on the card against the CPU: every kind of
filter, FilterBlur on uint8 one K1b launch a batch, FilterBackground on
uint8 one K1 diff-emit launch a batch, mask_boundary one K1m launch, and
BatchStager running a BGR chain on the card once a batch. The filter
chain's and the EDT's kernels (csrc/filters.cu, csrc/distance.cu): KE on
the CPU model's scenes and on 1080p masks (random densities, no zero, no
foreground) with its pass counts, KM on random BGR (tails, unaligned
slices, float32) and KR on random gray and BGR (both routes, a view at a
byte offset, rows not 16-byte multiples), KW under both borders with
an out_size and an inverse map, each bit-equal to its plain version on the
card, small and at 1080p, one launch a call. KS (csrc/background.cu, the
float background) in both orders and KG (the float blur, csrc/filters.cu)
bit-equal to their plain versions at odd and even N, past shared memory,
edge shapes and both layouts, one launch a call; the scanned route
(parallel_bg) and FilterBlur and FilterBackground on float frames launch
them and equal the CPU. The band path's CCL kernels (KB: band_labels,
recon_edges, recon_min, piece_table, piece_sums; csrc/ccl.cu and
csrc/spatial.cu) bit-equal to their plain versions on bands of 270 rows
(even first rows) and 135 rows (odd) of a 1080p mask batch and round by
round on the serpentine scene, one launch a call. The CCL scenes
(tpuva_torch.scenes) are shared with the CPU tests that hold the plain
versions against tpuva.
"""

import numpy as np
import pytest
import torch

from tpuva_torch import filters as tf
from tpuva_torch.analysis.regions import mask_boundary
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.io.staging import BatchStager
from tpuva_torch.ops import color, connected_components_with_stats, distance, resize, warp
from tpuva_torch.ops.ccl import (
    label_components_tiled, label_stats, root_labels, root_occupancy_plain, root_stats,
    root_stats_dict, strip_occupancy_plain, strip_shape,
)
from tpuva_torch.ops import background as bgo
from tpuva_torch.ops.filters import (
    _morph, blur_taps, gaussian_blur, gaussian_blur_plain, gaussian_blur_u8, histogram_u8,
    histogram_u8_plain, structuring_element,
)
from tpuva_torch.ops.fused_segment import (
    TILES,
    _fused_segment_cuda,
    fused_segment,
    fused_segment_plain,
    fused_tile,
)
from tpuva_torch.ops.label import _stats_dict, label_components, relabel_dense, root_stats_plain
from tpuva_torch.ops.wide import blur_u8, morph_u8
from tpuva_torch.probes import cell_probe, i16_probe, latency_probe, repos_probe, roll_probe
from tpuva_torch.probes._timing import timeit
from tpuva_torch.scenes import (
    DET_KINDS, K1_REFUSED, ROOT_STATS_OPTIONS, conn4_scene, det_sequence, edge_strip_scene,
    edt_large_scenes, edt_scenes, k1_refused_config, median_adversarial, mixed_scene,
    piece_overflow_clip, serpentine_clip, u_shape,
)
from tpuva_torch.ops import band_ccl
from tpuva_torch.track.scan import scan_plan, track_scan, track_scan_plain
from tpuva_torch.track.table import TrackState, init_track_state

BENCH = dict(
    alpha=0.02, threshold=35.0, blur_ksize=5, blur_sigma=0.0,
    open_shape="rect", open_ksize=3, close_shape="ellipse", close_ksize=3,
)
CONFIGS = {
    "bench": BENCH,
    "median3": dict(BENCH, median_ksize=3),
    "k7_sigma_iters2": dict(
        alpha=0.05, threshold=20.0, blur_ksize=7, blur_sigma=1.5,
        open_shape="ellipse", open_ksize=5, open_iters=2,
        close_shape="rect", close_ksize=3, close_iters=2,
    ),
}

# K1's instantiations (blur 0 and 1..7 taps unrolled, 9 and 63 taps generic)
# and edge paths (median, SE 31 with iterations: a reach wider than the
# small images, so the reflect tables reflect more than once)
K1_CONFIGS = dict(
    CONFIGS,
    blur0=dict(BENCH, blur_ksize=0),
    blur3=dict(BENCH, blur_ksize=3),
    blur9=dict(BENCH, blur_ksize=9),
    blur63_median3=dict(BENCH, blur_ksize=63, blur_sigma=4.0, median_ksize=3),
    se31=dict(BENCH, open_shape="ellipse", open_ksize=31, close_shape="rect",
              close_ksize=5, close_iters=2),
)
# N = 1 and an image smaller than one tile; one row; one column; W % 16
# != 0 (rows start unaligned: byte stores) and W % 4 == 0 (4-byte stores);
# W % 16 == 0 (16-byte stores)
K1_SHAPES = [(5, 64, 256), (4, 50, 100), (3, 250, 333), (2, 7, 5), (1, 9, 13), (2, 1, 40),
             (2, 40, 1)]


def scene(N, H, W, seed):
    """A noisy plate with moving bright disks and saturated uint8 patches.
    Returns (frames (N, H, W) uint8, bg0 (H, W) float32)."""
    rng = np.random.default_rng(seed)
    plate = rng.integers(15, 40, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    frames = np.empty((N, H, W), np.uint8)
    for t in range(N):
        f = plate + rng.normal(0, 3, (H, W))
        for k in range(3):
            cy = (H * (0.2 + 0.3 * k) + 3 * t) % H
            cx = (W * (0.15 + 0.3 * k) + 5 * t) % W
            f[(yy - cy) ** 2 + (xx - cx) ** 2 <= (4 + 2 * k) ** 2] = 210
        f[t % H, :] = 255  # a saturated row moving down
        frames[t] = np.clip(np.rint(f), 0, 255).astype(np.uint8)
    frames[:, -2:, -3:] = 0
    bg0 = (plate + rng.random((H, W))).astype(np.float32)
    return frames, bg0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch while this module's tests run (the
    other test_torch_* files import this fixture). The test suite runs as
    several pytest-xdist workers on one machine; torch's default of one
    thread per core in each worker oversubscribes it and slows the tiny
    plain versions here, and the JAX tests beside them, many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(K1_CONFIGS))
def test_fused_segment_kernel_matches_plain(cuda_device, name):
    kw = K1_CONFIGS[name]
    for shape in K1_SHAPES:
        frames, bg0 = scene(*shape, seed=1)
        for seed_bg in (False, True):
            ref = fused_segment_plain(
                torch.from_numpy(frames), torch.from_numpy(bg0), seed_bg=seed_bg, **kw
            )
            before = fused_segment.launches
            got = fused_segment(
                torch.from_numpy(frames).to(cuda_device),
                torch.from_numpy(bg0).to(cuda_device), seed_bg=seed_bg, **kw,
            )
            torch.cuda.synchronize()
            assert fused_segment.launches == before + 1
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(g.cpu().numpy(), r.numpy(), err_msg=f"{shape}")


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILES, ids=[f"{h}x{w}" for h, w in TILES])
def test_fused_segment_kernel_tiles_match_plain(cuda_device, tile):
    """Every tile launch_plan weighs, forced, with both emits: interior
    tiles (the straight window load), edge tiles (the reflect tables) and
    ragged last tiles, on 16-byte (W = 256) and byte (W = 333) rows."""
    diff_kw = dict(alpha=0.02, threshold=0.0, blur_ksize=5, emit="diff")
    for shape in [(3, 200, 256), (2, 150, 333), (2, 7, 5)]:
        frames, bg0 = scene(*shape, seed=6)
        for kw in (BENCH, diff_kw):
            ref = fused_segment_plain(torch.from_numpy(frames), torch.from_numpy(bg0), **kw)
            got = _fused_segment_cuda(torch.from_numpy(frames).to(cuda_device),
                                      torch.from_numpy(bg0).to(cuda_device), tile=tile, **kw)
            torch.cuda.synchronize()
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(g.cpu().numpy(), r.numpy(),
                                              err_msg=f"{shape}, {kw.get('emit', 'mask')}")


# K1's stream axis: the emits (and padded_occ), and configs whose blur or
# morphology leaves K1 (a stream at a time on the card)
K1_STREAM_CASES = {
    "mask": dict(BENCH),
    "diff": dict(alpha=0.02, threshold=0.0, blur_ksize=5, emit="diff"),
    "padded_occ": dict(BENCH, padded_occ=True),
    "median3": dict(BENCH, median_ksize=3),
    "split_reach": dict(BENCH, open_ksize=7, open_iters=10, close_ksize=7, close_iters=10),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(K1_STREAM_CASES))
def test_fused_segment_kernel_streams_match_plain(cuda_device, name):
    """K1 with a stream axis against its plain version on the CPU, bit for
    bit: S = 3 streams, each its own scene and plate, at a 16-byte (W = 256)
    and a byte (W = 333) row pitch, as a stack and as a list of batches that
    lie apart, with one seed flag for all and a mixed flag tensor on the
    card; one launch for all streams where K1 takes the config, and each
    stream's output equal to its own single-stream launch."""
    kw = K1_STREAM_CASES[name]
    split = name == "split_reach"
    for shape in [(4, 64, 256), (3, 50, 333)]:
        scenes = [scene(*shape, seed=10 + s) for s in range(3)]
        frames = torch.from_numpy(np.stack([f for f, _ in scenes]))
        bg0 = torch.from_numpy(np.stack([b + 3 * s for s, (_, b) in enumerate(scenes)]))
        f_gpu, b_gpu = frames.to(cuda_device), bg0.to(cuda_device)
        apart = [f.clone() for f in f_gpu]  # three allocations, read through pointers
        for seed in (False, True, torch.tensor([True, False, True])):
            seed_dev = seed.to(cuda_device) if isinstance(seed, torch.Tensor) else seed
            ref = fused_segment_plain(frames, bg0, seed_bg=seed, **kw)
            for what, got_frames in (("stack", f_gpu), ("list", apart)):
                before = (fused_segment.launches, fused_segment.stream_launches)
                got = fused_segment(got_frames, b_gpu, seed_bg=seed_dev, **kw)
                torch.cuda.synchronize()
                if not split:
                    assert (fused_segment.launches, fused_segment.stream_launches) == (
                        before[0] + 1, before[1] + 1)
                for r, g in zip(ref, got):
                    np.testing.assert_array_equal(g.cpu().numpy(), r.numpy(),
                                                  err_msg=f"{shape}, {what}, seed {seed}")
            one = fused_segment(apart[1], b_gpu[1],  # stream 1 alone
                                seed_bg=seed_dev[1] if isinstance(seed, torch.Tensor) else seed,
                                **kw)
            for r, g in zip(ref, one):
                np.testing.assert_array_equal(g.cpu().numpy(), r[1].numpy(), err_msg=f"{shape}")


@pytest.mark.gpu
def test_fused_segment_kernel_repeats_across_layouts(cuda_device):
    """Launches of different shared-memory layouts in turn, on 16-byte rows
    (the cp.async window copies, whose edge tiles read the reflect tables):
    a CTA's shared memory starts with the last CTA's bytes, so every launch
    must equal the plain version, the tenth as the first."""
    diff_kw = dict(alpha=0.02, threshold=0.0, blur_ksize=5, emit="diff")
    frames, bg0 = scene(4, 256, 512, seed=8)
    runs = [(kw, False) for kw in (diff_kw, K1_CONFIGS["blur9"], K1_CONFIGS["median3"])]
    runs += [(BENCH, True)]
    refs = [fused_segment_plain(torch.from_numpy(frames), torch.from_numpy(bg0),
                                padded_occ=padded, **kw) for kw, padded in runs]
    f_gpu, b_gpu = torch.from_numpy(frames).to(cuda_device), torch.from_numpy(bg0).to(cuda_device)
    for i in range(10):
        for (kw, padded), ref in zip(runs, refs):
            got = fused_segment(f_gpu, b_gpu, padded_occ=padded, **kw)
            torch.cuda.synchronize()
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(g.cpu().numpy(), r.numpy(),
                                              err_msg=f"repeat {i}, {kw}, padded={padded}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(K1_CONFIGS))
def test_fused_segment_diff_kernel_matches_plain(cuda_device, name):
    """emit="diff" (no morphology), and alpha 0 with bg0 = k + 0.5, where
    every magnitude is a .5 tie that rint takes to the even neighbour."""
    kw = {k: v for k, v in K1_CONFIGS[name].items()
          if k in ("alpha", "blur_ksize", "blur_sigma", "median_ksize")}
    cases = []
    for shape in K1_SHAPES:
        frames, bg0 = scene(*shape, seed=2)
        cases += [(frames, bg0, kw, False), (frames, bg0, kw, True)]
    frames, _ = scene(3, 40, 70, seed=4)
    ties = (np.random.default_rng(4).integers(0, 255, (40, 70)) + 0.5).astype(np.float32)
    cases.append((frames, ties, dict(kw, alpha=0.0), False))
    for frames, bg0, k, seed_bg in cases:
        args = dict(threshold=0.0, seed_bg=seed_bg, emit="diff", **k)
        ref = fused_segment_plain(torch.from_numpy(frames), torch.from_numpy(bg0), **args)
        before = fused_segment.launches
        got = fused_segment(torch.from_numpy(frames).to(cuda_device),
                            torch.from_numpy(bg0).to(cuda_device), **args)
        torch.cuda.synchronize()
        assert fused_segment.launches == before + 1
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.cpu().numpy(), r.numpy(), err_msg=f"{frames.shape}")


# blur sizes for K1b: K1's own range, and past its 63 taps (sigma 0 and a
# wide sigma: the u8_gaussian_taps quantizer), up to 255 taps
WIDE_BLURS = [(3, 0.0), (5, 0.0), (9, 0.0), (63, 4.0), (65, 0.0), (101, 30.0), (255, 0.0)]


def unaligned(x: np.ndarray, device) -> torch.Tensor:
    """x on the device as a contiguous view at storage offset 1 (its
    data_ptr not 16-byte aligned)."""
    base = torch.zeros(x.size + 1, dtype=torch.uint8, device=device)
    view = base[1:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("ksize, sigma", WIDE_BLURS)
def test_blur_u8_kernel_matches_plain(cuda_device, ksize, sigma):
    """K1b against gaussian_blur_u8 on every K1 shape (a tap reach wider
    than the image, one row, one column, 7 x 5: reflected many times; W not
    a multiple of 4 or 16), aligned and at storage offset 1, one launch a
    call."""
    for shape in K1_SHAPES + [(2, 64, 272)]:
        frames, _ = scene(*shape, seed=12)
        ref = gaussian_blur_u8(torch.from_numpy(frames), ksize, sigma).to(torch.uint8)
        for x in (torch.from_numpy(frames).to(cuda_device), unaligned(frames, cuda_device)):
            before = blur_u8.launches
            got = blur_u8(x, ksize, sigma)
            torch.cuda.synchronize()
            assert blur_u8.launches == before + 1
            np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy(), err_msg=f"{shape}")


# K1b's instantiations and paths besides cv2's taps of at most 255:
# asymmetric taps (__dp4a and __dp2a_lo; the window's columns at every
# offset in their 16-byte chunk), a tap of 256 (a multiply-add a tap),
# cv2's 65 taps at sigma 0.1 (a centre tap of 256), and 1001 taps, whose
# window fits no tile (the two global passes)
BLUR_INSTANTIATIONS = {
    "asym_dp4a": ((1, 2, 5, 9, 3, 0, 7), 5), "asym21_dp4a": ((2,) * 9 + (3,) * 12, 6),
    "asym_256": ((0, 256, 1), 8), "centre_256": blur_taps(65, 0.1), "global": blur_taps(1001, 0.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BLUR_INSTANTIATIONS))
def test_blur_u8_kernel_instantiations(cuda_device, name):
    """K1b's other instantiations against the integer correlation they
    compute, as blur_plan picks them."""
    from tpuva_torch.ops.filters import _conv_axis_int
    from tpuva_torch.ops.wide import _blur_cuda, blur_plan

    taps, shift = BLUR_INSTANTIATIONS[name]
    for shape in K1_SHAPES + [(2, 64, 272)]:
        frames, _ = scene(*shape, seed=14)
        x = torch.from_numpy(frames)
        y = _conv_axis_int(_conv_axis_int(x.to(torch.int32), taps, 2), taps, 1)
        ref = ((y + (1 << (shift - 1))) >> shift).to(torch.uint8)
        plan = blur_plan(*shape[1:], taps)
        assert plan.dp == (max(taps) <= 255)
        assert (plan.kernel == "global") == (name == "global")
        got = _blur_cuda(x.to(cuda_device), taps, shift)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy(), err_msg=f"{shape}")


@pytest.mark.gpu
@pytest.mark.parametrize("shape_name", ["rect", "ellipse", "random"])
@pytest.mark.parametrize("ksize", [1, 3, 7, 33, 45])
def test_morph_u8_kernel_matches_plain(cuda_device, shape_name, ksize):
    """K1m, one erode and one dilate step, against filters._morph on every
    K1 shape, on 0/255 masks (the AND/OR path) and on arbitrary bytes
    (__vminu4/__vmaxu4); SEs wider than the image included, and random
    ones with several runs a row, without their anchor too (no skip of
    all-zero tiles then); one launch a step."""
    rng = np.random.default_rng(ksize)
    if shape_name == "random":
        se = rng.random((ksize, ksize)) < 0.5
        se[ksize // 2, ksize // 2] = ksize != 45
    else:
        se = structuring_element(shape_name, ksize)
    for shape in K1_SHAPES:
        frames, _ = scene(*shape, seed=13)
        for x in (np.where(frames > 100, 255, 0).astype(np.uint8),
                  rng.integers(0, 256, shape, dtype=np.uint8), np.zeros(shape, np.uint8)):
            for erode in (True, False):
                ref = _morph(torch.from_numpy(x), se, erode)
                before = morph_u8.launches
                got = morph_u8(torch.from_numpy(x).to(cuda_device), se, erode)
                torch.cuda.synchronize()
                assert morph_u8.launches == before + 1
                np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy(),
                                              err_msg=f"{shape}, erode={erode}")


def mixed_steps(n, seed):
    """n erode and dilate steps in a random order over rect, ellipse and
    random SEs (several runs a row) of a few sizes."""
    rng = np.random.default_rng(seed)
    ses = [structuring_element("rect", 3), structuring_element("rect", 7),
           structuring_element("ellipse", 7), structuring_element("ellipse", 5),
           rng.random((5, 9)) < 0.5, np.ones((1, 5), bool)]
    ses[4][2, 4] = True
    return [(ses[int(rng.integers(len(ses)))], bool(rng.integers(2))) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", range(1, 13))
def test_morph_steps_kernel_matches_plain(cuda_device, n):
    """K1m's grouped launches: n mixed erode and dilate steps against the
    chain of _morph steps, one launch a group of morph_plan, on every K1
    shape (the group's halo wider and taller than the image) and a 1080p
    crop, aligned and at storage offset 1, masks and arbitrary bytes; with
    pad_to, the last group's padded mask and occ128 against pad_occ_plain."""
    from tpuva_torch.ops.wide import morph_plan, morph_steps, pad_occ_plain

    steps = mixed_steps(n, seed=n)
    for shape in K1_SHAPES + [(1, 1, 1), (1, 1, 333), (2, 270, 480)]:
        frames, _ = scene(*shape, seed=15)
        masks = np.where(frames > 100, 255, 0).astype(np.uint8)
        plan = morph_plan(*shape[1:], steps)
        for x in (masks, np.random.default_rng(n).integers(0, 256, shape, dtype=np.uint8)):
            ref = torch.from_numpy(x)
            for se, erode in steps:
                ref = _morph(ref, se, erode)
            for dev_x in (torch.from_numpy(x).to(cuda_device), unaligned(x, cuda_device)):
                before = morph_u8.launches
                got = morph_steps(dev_x, steps)
                torch.cuda.synchronize()
                assert morph_u8.launches == before + len(plan)
                np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy(), err_msg=f"{shape}")
        pad_to = (-(-shape[1] // 2) * 2, -(-shape[2] // 128) * 128 + 128)
        ref_p, ref_o = pad_occ_plain(ref, pad_to)
        got_p, got_o = morph_steps(unaligned(x, cuda_device), steps, pad_to=pad_to)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got_p.cpu().numpy(), ref_p.numpy(), err_msg=f"{shape}")
        np.testing.assert_array_equal(got_o.cpu().numpy(), ref_o.numpy(), err_msg=f"{shape}")


@pytest.mark.gpu
def test_morph_step_kernel_past_every_tile(cuda_device):
    """An SE whose single step no tile's buffers hold (1 x 8001) takes the
    one-step global kernel, as morph_plan says, between tiled groups."""
    from tpuva_torch.ops.wide import morph_plan, morph_steps

    wide_se = np.ones((1, 8001), bool)
    steps = [(wide_se, True), (structuring_element("rect", 3), False), (wide_se, False)]
    assert [g.kernel for g in morph_plan(3, 50, steps)] == ["step", "tiled", "step"]
    for x in (np.random.default_rng(5).integers(0, 256, (2, 3, 50), dtype=np.uint8),
              np.random.default_rng(6).integers(0, 256, (2, 3, 9000), dtype=np.uint8)):
        ref = torch.from_numpy(x)
        for se, erode in steps:
            ref = _morph(ref, se, erode)
        got = morph_steps(torch.from_numpy(x).to(cuda_device), steps)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


# options one K1 launch does not take: (options, blur_u8 and morph_u8
# launches a call on a (N, 100, 160) batch; K1m's are morph_plan's groups,
# tests/test_torch_wide.py)
SPLIT_CONFIGS = {
    "reach120": (dict(BENCH, open_ksize=7, open_iters=10, close_ksize=7, close_iters=10),
                 0, 4),
    "se33_median3": (dict(BENCH, median_ksize=3, close_shape="ellipse", close_ksize=33), 0, 2),
    "blur65": (dict(BENCH, blur_ksize=65), 1, 0),
    "blur65_se33": (dict(BENCH, blur_ksize=65, close_ksize=33), 1, 2),
    "blur101_diff": (dict(alpha=0.02, threshold=0.0, blur_ksize=101, blur_sigma=30.0,
                          median_ksize=3, emit="diff"), 1, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SPLIT_CONFIGS))
def test_fused_segment_split_matches_plain(cuda_device, name):
    """fused_segment on the card for options one K1 launch does not take:
    K1b before K1 and K1m steps after it as k1_split says, one K1 launch,
    masks (or magnitudes) and background bit-equal to the one-pass plain
    version, seeded or not."""
    kw, n_blur, n_morph = SPLIT_CONFIGS[name]
    frames, bg0 = scene(4, 100, 160, seed=11)
    frames[1:, 10:95, 20:140] = 220  # a patch wider than reach120's erosion
    for seed_bg in (False, True):
        ref = fused_segment_plain(torch.from_numpy(frames), torch.from_numpy(bg0),
                                  seed_bg=seed_bg, **kw)
        before = fused_segment.launches, blur_u8.launches, morph_u8.launches
        got = fused_segment(torch.from_numpy(frames).to(cuda_device),
                            torch.from_numpy(bg0).to(cuda_device), seed_bg=seed_bg, **kw)
        torch.cuda.synchronize()
        after = fused_segment.launches, blur_u8.launches, morph_u8.launches
        assert tuple(a - b for a, b in zip(after, before)) == (1, n_blur, n_morph)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.cpu().numpy(), r.numpy(), err_msg=f"{seed_bg}")
        assert ref[0].any()


# padded_occ: configs of one K1 launch, and splits whose open and close
# leave K1 (the last K1m step writes the padded mask and occ128)
PADDED_CONFIGS = {
    "bench": BENCH,
    "median3": CONFIGS["median3"],
    "k7_sigma_iters2": CONFIGS["k7_sigma_iters2"],
    "split_reach120": SPLIT_CONFIGS["reach120"][0],
    "split_blur65_se33": SPLIT_CONFIGS["blur65_se33"][0],
}
# aligned to 64 x 256 (the staged route's handoff), ragged, one row, and an
# image smaller than one tile
PADDED_SHAPES = [(3, 120, 200), (2, 250, 333), (2, 1, 40), (2, 9, 13), (3, 160, 240)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PADDED_CONFIGS))
def test_fused_segment_padded_occ_kernel_matches_plain(cuda_device, name):
    """K1 with padded_occ on the card against its plain version: the
    (N, Hp, Wp) mask with its zero padding, occ128 and the background bit
    for bit, seeded or not; one padded K1 launch where the morphology stays
    in K1."""
    from tpuva_torch.ops.fused_segment import k1_split

    kw = PADDED_CONFIGS[name]
    for shape in PADDED_SHAPES:
        frames, bg0 = scene(*shape, seed=2)
        frames[1:, shape[1] // 4: shape[1] // 2 + 1, shape[2] // 4: shape[2] // 2 + 1] = 220
        for seed_bg in (False, True):
            ref = fused_segment_plain(torch.from_numpy(frames), torch.from_numpy(bg0),
                                      seed_bg=seed_bg, padded_occ=True, **kw)
            before = fused_segment.padded_launches
            got = fused_segment(torch.from_numpy(frames).to(cuda_device),
                                torch.from_numpy(bg0).to(cuda_device), seed_bg=seed_bg,
                                padded_occ=True, **kw)
            torch.cuda.synchronize()
            in_k1 = not k1_split(*shape[1:], **kw)[1]
            assert fused_segment.padded_launches == before + in_k1
            assert got[0].shape == (shape[0], *fused_tile(*shape[1:])[2:])
            for what, r, g in zip(("masks", "bg", "occ128"), ref, got):
                np.testing.assert_array_equal(g.cpu().numpy(), r.numpy(),
                                              err_msg=f"{what}, {shape}, seed_bg={seed_bg}")


def strip_occ_scenes():
    """(name, mask (N, H, W) uint8): six blobs at 1080p, random masks of
    density 0.05, 0.3 and 0.45 (long chains in the union-find), an
    all-empty batch, the CCL scenes, odd sizes."""
    rng = np.random.default_rng(9)
    scenes = [("mixed", mixed_scene()), ("u_shape", u_shape(192, 768)[None]),
              ("empty", np.zeros((3, 120, 512), np.uint8)),
              ("random_0.45", ((rng.random((4, 250, 333)) < 0.45) * 255).astype(np.uint8))]
    for p in (0.05, 0.3):
        scenes.append((f"random_{p}", ((rng.random((4, 250, 333)) < p) * 255).astype(np.uint8)))
        scenes.append((f"random_{p}_1080p", ((rng.random((2, 1080, 1920)) < p) * 255)
                       .astype(np.uint8)))
    blobs = np.zeros((3, 1080, 1920), np.uint8)
    yy, xx = np.mgrid[:1080, :1920]
    for t in range(3):
        for k in range(6):
            cy, cx = 90 + 170 * k + 7 * t, 150 + 300 * k
            blobs[t][(yy - cy) ** 2 + (xx - cx) ** 2 <= 16 ** 2] = 255
    scenes.append(("six_blobs_1080p", blobs))
    for shape in ((2, 7, 9), (3, 1, 1), (2, 1, 600), (2, 600, 1)):
        scenes.append((f"odd_{shape}", ((rng.random(shape) < 0.5) * 255).astype(np.uint8)))
    return scenes


@pytest.mark.gpu
def test_ccl_strip_occ_kernel_matches_plain(cuda_device):
    """K2 on the card given the strip occupancy of the mask padded to
    64 x 256 (the staged route's handoff), against K2 deriving the
    occupancy from the cropped mask and against the plain version: every
    stats field bit for bit, on sparse, dense and empty masks."""
    for name, mask in strip_occ_scenes():
        N, H, W = mask.shape
        Hp, Wp = -(-H // 64) * 64, -(-W // 256) * 256
        padded = np.zeros((N, Hp, Wp), np.uint8)
        padded[:, :H, :W] = mask
        occ = strip_occupancy_plain(torch.from_numpy(padded))
        assert occ.shape == (N, *strip_shape(Hp, Wp))
        padded_gpu, occ = torch.from_numpy(padded).to(cuda_device), occ.to(cuda_device)
        for C in (8, 32):
            ref = label_stats(torch.from_numpy(mask), C)
            before = label_stats.launches, label_stats.occ_launches
            derived = label_stats(torch.from_numpy(mask).to(cuda_device), C)
            given = label_stats(padded_gpu, C, strip_occ=occ, H=H, W=W)
            torch.cuda.synchronize()
            assert (label_stats.launches, label_stats.occ_launches) == (before[0] + 2,
                                                                       before[1] + 1)
            for k in ("count", "area", "centroid", "centroid_sum", "overflow"):
                for what, got in (("derived", derived), ("given", given)):
                    np.testing.assert_array_equal(got[k].cpu().numpy(), ref[k].numpy(),
                                                  err_msg=f"{name}, C={C}, {what}, {k}")


@pytest.mark.gpu
def test_ccl_kernel_components_past_c(cuda_device):
    """K2's epilogue and root table at the ends of C: one component kept
    of many, the kernel's largest C (1024, past the frames' components),
    on random masks deriving the occupancy and given it; every stats field
    bit for bit, each call one launch."""
    rng = np.random.default_rng(11)
    mask = ((rng.random((3, 250, 333)) < 0.3) * 255).astype(np.uint8)
    occ = strip_occupancy_plain(torch.from_numpy(mask)).to(cuda_device)
    m_gpu = torch.from_numpy(mask).to(cuda_device)
    for C in (1, 1024):
        ref = label_stats(torch.from_numpy(mask), C)
        before = label_stats.launches
        for what, got in (("derived", label_stats(m_gpu, C)),
                          ("given", label_stats(m_gpu, C, strip_occ=occ.bool(), H=250, W=333))):
            for k in ("count", "area", "centroid", "centroid_sum", "overflow"):
                np.testing.assert_array_equal(got[k].cpu().numpy(), ref[k].numpy(),
                                              err_msg=f"C={C}, {what}, {k}")
        assert label_stats.launches == before + 2


@pytest.mark.gpu
def test_histogram_kernel_matches_plain(cuda_device):
    """Odd sizes (frames that start off 16-byte alignment), a single
    pixel, a frame spanning several CTAs, one heavy bin, leading dims."""
    rng = np.random.default_rng(3)
    for shape in [(5, 250, 333), (3, 1, 1), (2, 7, 9), (2, 600, 700), (4, 64, 256)]:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        x[:, : shape[1] // 2] = 1
        before = histogram_u8.launches
        got = histogram_u8(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert histogram_u8.launches == before + 1
        ref = histogram_u8_plain(torch.from_numpy(x)).to(torch.float32)
        np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy(), err_msg=f"{shape}")
    x = rng.integers(0, 256, (2, 3, 20, 30), dtype=np.uint8)
    got = histogram_u8(torch.from_numpy(x).to(cuda_device))
    assert got.shape == (2, 3, 256)
    np.testing.assert_array_equal(got.cpu().numpy(), histogram_u8(torch.from_numpy(x)).numpy())


@pytest.mark.gpu
def test_ccl_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(7)
    scenes = [mixed_scene(), u_shape(192, 768)[None], np.zeros((2, 9, 11), np.uint8)]
    for p in (0.05, 0.3, 0.45):
        scenes.append(((rng.random((4, 250, 333)) < p) * 255).astype(np.uint8))
    for mask in scenes:
        for C in (8, 32):
            ref = label_stats(torch.from_numpy(mask), C)
            before = label_stats.launches
            got = label_stats(torch.from_numpy(mask).to(cuda_device), C)
            torch.cuda.synchronize()
            assert label_stats.launches == before + 1
            for k in ("count", "area", "centroid", "centroid_sum", "overflow"):
                np.testing.assert_array_equal(got[k].cpu().numpy(), ref[k].numpy(), err_msg=k)


def label_scenes():
    """Masks for K3: the CCL scenes above, random masks of three densities,
    odd sizes (the ragged last 2x2-block row and column) and a full frame."""
    rng = np.random.default_rng(5)
    scenes = [mixed_scene(), u_shape(192, 768)[None], np.zeros((2, 9, 11), np.uint8),
              np.full((1, 33, 65), 255, np.uint8)]
    for p in (0.05, 0.3, 0.45):
        scenes.append(((rng.random((4, 250, 333)) < p) * 255).astype(np.uint8))
    for shape in ((2, 7, 9), (3, 1, 1), (2, 1, 33), (2, 40, 1)):
        scenes.append(((rng.random(shape) < 0.5) * 255).astype(np.uint8))
    return scenes


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", [4, 8])
def test_dense_label_kernel_matches_plain(cuda_device, connectivity):
    for mask in label_scenes():
        ref = label_components(torch.from_numpy(mask), connectivity)
        before = label_components_tiled.launches
        got = label_components_tiled(torch.from_numpy(mask).to(cuda_device), connectivity)
        torch.cuda.synchronize()
        assert label_components_tiled.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy(), err_msg=f"{mask.shape}")
    # 2-D and bool input
    m = u_shape(40, 60)
    got = label_components_tiled(torch.from_numpy(m != 0).to(cuda_device), connectivity)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  label_components(torch.from_numpy(m), connectivity).numpy())


@pytest.mark.gpu
def test_dense_label_kernel_skips_empty_strips(cuda_device):
    """K3 8-connected visits only occupied strips: on the edge-strip scenes
    (one occupied strip at each ragged edge, components across tile and
    strip borders, every pixel, none, density 0.3), odd and with W % 4 == 0
    (16-byte stores), bit-equal to its plain version; the occupancy it
    hands back is strip_occupancy_plain's."""
    for H, W in ((71, 601), (70, 600), (72, 1024)):
        mask = edge_strip_scene(H, W)
        before = label_components_tiled.launches
        got, occ = root_labels(torch.from_numpy(mask).to(cuda_device), 8)
        torch.cuda.synchronize()
        assert label_components_tiled.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      label_components(torch.from_numpy(mask), 8).numpy(),
                                      err_msg=f"{mask.shape}")
        np.testing.assert_array_equal(occ.cpu().numpy(),
                                      strip_occupancy_plain(torch.from_numpy(mask)).numpy())


STATS_KEYS = ("labels", "count", "area", "bbox", "centroid", "centroid_sum", "overflow")


def assert_stats_equal(got, ref, where):
    """Every key of two stats dicts bit for bit (the float32 centroid's
    bits too)."""
    for k in STATS_KEYS:
        g, r = got[k].cpu(), ref[k]
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        np.testing.assert_array_equal(g.numpy(), r.numpy(), err_msg=f"{where}, {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 256])
def test_dense_label_kernel_4_skips_empty_segments(cuda_device, N):
    """K3 4-connected visits only the occupied strips' segments: on
    conn4_scene (tile and strip borders, diagonal contacts across a tile
    corner next to empty tiles, H % 16 != 0 and W % 4 != 0, empty and full
    frames) and at W % 4 == 0 (16-byte stores), batches of N frames (the
    scene's frames repeated), bit-equal to its plain version; the
    occupancy it hands back is root_occupancy_plain's."""
    for H, W in ((45, 601), (48, 1024)):
        scene = conn4_scene(H, W)
        mask = np.concatenate([scene] * -(-N // len(scene)))[:N]
        ref = label_components(torch.from_numpy(scene), 4).numpy()
        before = label_components_tiled.launches, label_components_tiled.conn4_launches
        got, occ = root_labels(torch.from_numpy(mask).to(cuda_device), 4)
        torch.cuda.synchronize()
        assert (label_components_tiled.launches, label_components_tiled.conn4_launches) == (
            before[0] + 1, before[1] + 1)
        got = got.cpu().numpy()
        for i in range(N):
            np.testing.assert_array_equal(got[i], ref[i % len(scene)], err_msg=f"{(H, W)}, {i}")
        np.testing.assert_array_equal(
            occ.cpu().numpy(), root_occupancy_plain(torch.from_numpy(mask), 4).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", [4, 8])
def test_root_stats_kernel_matches_plain(cuda_device, connectivity):
    """K6 against its plain version, bit for bit, at every option, C = 1,
    8, 32 and 64 (frames with more components than C), 2000 (the sums with
    a bbox past shared memory) and 13000 (the table too), deriving the
    occupancy and given K3's: the raw outputs (count, sums, bbox extremes,
    dense ids) and the stats dict (every key: root_stats_dict against
    root_stats_plain and _stats_dict), one launch each."""
    for mask in (edge_strip_scene(), edge_strip_scene(70, 600), mixed_scene(), label_scenes()[5],
                 conn4_scene()):
        root_cpu = label_components(torch.from_numpy(mask), connectivity)
        root, occ = root_labels(torch.from_numpy(mask).to(cuda_device), connectivity)
        np.testing.assert_array_equal(root.cpu().numpy(), root_cpu.numpy())
        np.testing.assert_array_equal(occ.cpu().numpy(),
                                      root_occupancy_plain(root_cpu, connectivity).numpy())
        for C in (1, 8, 32, 64, 2000, 13000):
            for given in (None, occ):
                where = f"{mask.shape}, C={C}, given={given is not None}"
                for sums, bbox, labels in ROOT_STATS_OPTIONS:
                    ref = root_stats_plain(root_cpu, C, connectivity, sums, bbox, labels)
                    before = root_stats.launches, root_stats.occ_launches
                    got = root_stats(root, C, connectivity, sums, bbox, labels, strip_occ=given)
                    torch.cuda.synchronize()
                    assert (root_stats.launches, root_stats.occ_launches) == (
                        before[0] + 1, before[1] + (given is not None))
                    for name, g, r in zip(("count", "sums", "lohi", "dense"), got, ref):
                        assert (g is None) == (r is None), name
                        if g is not None:
                            np.testing.assert_array_equal(
                                g.cpu().numpy(), r.numpy(),
                                err_msg=f"{where}, {(sums, bbox, labels)}, {name}")
                for bbox, labels in ((False, False), (True, False), (False, True), (True, True)):
                    ref = _stats_dict(*root_stats_plain(root_cpu, C, connectivity, True, bbox,
                                                        labels), *mask.shape[1:])
                    before = root_stats.launches
                    got = root_stats_dict(root, C, connectivity, bbox, labels, strip_occ=given)
                    torch.cuda.synchronize()
                    assert root_stats.launches == before + 1
                    assert_stats_equal(got, ref, f"{where}, bbox={bbox}, labels={labels}")


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", [4, 8])
def test_root_stats_kernel_is_one_launch(cuda_device, connectivity):
    """K6 makes one kernel launch a call, for the stats dict (every option,
    given K3's occupancy and deriving it) and the raw outputs, and no other
    kernel runs on the card for it (torch.profiler's CUDA kernels)."""
    from torch.profiler import ProfilerActivity, profile

    mask = torch.from_numpy(conn4_scene()).to(cuda_device)
    root, occ = root_labels(mask, connectivity)
    calls = [lambda b=b, lab=lab, o=o: root_stats_dict(root, 32, connectivity, b, lab,
                                                       strip_occ=o)
             for b in (False, True) for lab in (False, True) for o in (None, occ)]
    calls += [lambda o=o: root_stats(root, 32, connectivity, True, True, True, strip_occ=o)
              for o in (None, occ)]
    for fn in calls:
        fn()
        torch.cuda.synchronize()
        for _attempt in range(3):  # the profiler now and then records no kernel at all
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = {e.key: e.count for e in prof.key_averages()
                       if getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) > 0}
            if kernels:
                break
        assert list(kernels.values()) == [1] and "k6_frame" in next(iter(kernels)), kernels


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_with_stats_cuda_matches_cpu(cuda_device, connectivity):
    """K3 then K6 (given K3's occupancy) on the card against the plain
    versions on the CPU: every field at every option; and relabel_dense
    likewise."""
    for mask in (mixed_scene(), label_scenes()[5], u_shape(64, 96), edge_strip_scene(),
                 conn4_scene()):
        for C in (8, 64):
            for bbox, labels in ((True, True), (False, False), (True, False), (False, True)):
                ref = connected_components_with_stats(torch.from_numpy(mask), C, connectivity,
                                                      compute_bbox=bbox, compute_labels=labels)
                before = root_stats.launches, root_stats.occ_launches
                got = connected_components_with_stats(torch.from_numpy(mask).to(cuda_device), C,
                                                      connectivity, compute_bbox=bbox,
                                                      compute_labels=labels)
                assert (root_stats.launches, root_stats.occ_launches) == (
                    before[0] + 1, before[1] + 1)
                assert got["ccl_converged"] is True
                for k in ("labels", "count", "area", "bbox", "centroid", "centroid_sum",
                          "overflow"):
                    np.testing.assert_array_equal(got[k].cpu().numpy(), ref[k].numpy(),
                                                  err_msg=f"{k}, C={C}, {bbox}, {labels}")
            root = label_components(torch.from_numpy(mask), connectivity)
            ref = relabel_dense(root, C, connectivity)
            got = relabel_dense(root.to(cuda_device), C, connectivity)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("use_native", [False, True])
def test_batch_stager_cuda_yields_source_batches(cuda_device, use_native):
    rng = np.random.default_rng(1)
    clip = rng.integers(0, 256, (37, 30, 50), dtype=np.uint8)
    stager = BatchStager(VideoMemory(clip), 8, queue_depth=2, device=cuda_device,
                         use_native=use_native)
    try:
        got = [(n, b.clone()) for n, b in stager]
    finally:
        stager.close()
    assert [n for n, _ in got] == [8, 8, 8, 8, 5]
    for k, (n, b) in enumerate(got):
        assert b.device.type == "cuda" and b.dtype == torch.uint8 and b.shape == (8, 30, 50)
        np.testing.assert_array_equal(b[:n].cpu().numpy(), clip[8 * k:8 * k + n])
    np.testing.assert_array_equal(got[-1][1][5:].cpu().numpy(), np.repeat(clip[-1:], 3, axis=0))


@pytest.mark.gpu
@pytest.mark.parametrize("use_native", [False, True])
def test_batch_stager_cuda_slow_consumer_depth_one(cuda_device, use_native):
    """Queue depth 1 (two pinned slots), 1080p frames, a consumer whose
    stream is busy with other work before it reads each batch: a slot
    refilled while its copy was in flight would show as a wrong frame."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)

    class Frames(VideoMemory):  # 61 distinct frames over 8 stored ones
        def __init__(self):
            super().__init__(base)
            self._frame_count = 61

        def get_frame(self, index):
            f = base[index % 8].copy()
            f[0, :8] = np.frombuffer(np.int64(index).tobytes(), np.uint8)
            return f

    src = Frames()
    busy = torch.empty((4096, 4096), device=cuda_device)
    stager = BatchStager(src, 8, queue_depth=1, device=cuda_device, use_native=use_native)
    try:
        for k, (n, b) in enumerate(stager):
            busy = busy @ busy.T * 1e-4  # the consumer's stream is busy first
            ref = np.stack([src.get_frame(min(8 * k + i, 60)) for i in range(8)])
            assert n == min(8, 61 - 8 * k)
            np.testing.assert_array_equal(b.cpu().numpy(), ref)
    finally:
        stager.close()
    assert k == 7


@pytest.mark.gpu
def test_streaming_native_staging_on_card_equals_cpu(cuda_device):
    """The streamed default route fed by the C++ ring on the card (a
    decoder's source, which the stager sends through the ring): the CPU
    run's rows (plain versions, the Python feeder over a VideoMemory)."""
    from refimpl.synthetic import moving_disk_clip
    from tpuva_torch.graph.config import (
        BackgroundConfig, PipelineConfig, SegmentConfig, TrackConfig,
    )
    from tpuva_torch.graph.streaming import StreamingPipeline

    clip, _, plate = moving_disk_clip(h=96, w=128, frames=64, radius=8, seed=11)
    cfg = PipelineConfig(background=BackgroundConfig(alpha=0.03),
                         segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
                         track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
                         batch=8)
    from tpuva_torch.io.base import VideoBase

    class Decoded(VideoBase):  # frames only through get_frame
        def __init__(self):
            super().__init__(clip.shape[0], (clip.shape[2], clip.shape[1]), 25.0, False)

        def get_frame(self, index):
            return clip[index]

    ref = StreamingPipeline(cfg, device="cpu").run(VideoMemory(clip), background0=plate)
    sp = StreamingPipeline(cfg, device=cuda_device)
    stagers, make = [], sp._make_stager
    sp._make_stager = lambda source: stagers.append(make(source)) or stagers[-1]
    got = sp.run(Decoded(), background0=plate)
    assert got == ref and len(ref) > 50 and [s.native for s in stagers] == [True]


def _bits(x):
    """A tensor's bits, so that -0.0 and +0.0 differ."""
    x = x.cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def check_track_scan(state, dets, valid, frame0, device, **kw):
    """K5 on the card against track_scan_plain on the CPU, bit for bit;
    the input state stays as it was, and the launch took the kernel that
    scan_plan names for the table's shape. Returns the plain run's
    outputs."""
    ref = track_scan_plain(TrackState(*(x.cpu() for x in state)), torch.from_numpy(dets),
                           torch.from_numpy(valid), torch.tensor(frame0, dtype=torch.int32), **kw)
    gpu_state = TrackState(*(x.to(device) for x in state))
    before = [x.clone() for x in gpu_state]
    launches, kept = track_scan.launches, track_scan.kept_launches
    got = track_scan(gpu_state, torch.from_numpy(dets).to(device), torch.from_numpy(valid).to(device),
                     torch.tensor(frame0, dtype=torch.int32, device=device), **kw)
    torch.cuda.synchronize()
    assert track_scan.launches == launches + 1
    T, D = state.pos.shape[0], dets.shape[1]
    assert track_scan.kept_launches == kept + (scan_plan(T, D).kernel != "registers")
    for name, g, r in zip(TrackState._fields, got[0], ref[0]):
        np.testing.assert_array_equal(_bits(g).numpy(), _bits(r).numpy(), err_msg=name)
    np.testing.assert_array_equal(_bits(got[1]).numpy(), _bits(ref[1]).numpy(), err_msg="rows")
    np.testing.assert_array_equal(got[2].cpu().numpy(), ref[2].numpy(), err_msg="row_valid")
    assert all(torch.equal(a, b) for a, b in zip(gpu_state, before))
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
@pytest.mark.parametrize("kind", DET_KINDS)
def test_track_scan_kernel_matches_plain(cuda_device, kind, assigner):
    """Every detection stream at T in {1, 3, 16, 64}, D in {1, 8, 16}: 48
    frames from an empty table, then 48 more from the state they leave,
    the second batch's frames from 2^24 - 20 (float32 frames round)."""
    kw = dict(max_dist=40.0, death_patience=3, assigner=assigner)
    for T in (1, 3, 16, 64):
        for D in (1, 8, 16):
            dets, valid = det_sequence(kind, D, frames=96, seed=T * 5 + D)
            where = dict(T=T, D=D)
            ts, _rows, rv = check_track_scan(init_track_state(T, "cpu"), dets[:48], valid[:48], 7,
                                             cuda_device, **kw)
            _ts, _rows, rv2 = check_track_scan(ts, dets[48:], valid[48:], 2**24 - 20, cuda_device,
                                               **kw)
            assert int(rv.sum()) + int(rv2.sum()) > 0 or not valid.any(), where


def band_mask(N, H, W, seed):
    """(N, H, W) uint8 0/255: specks, disks of radius 3-40 and lines across
    the rows, so that pieces cross band edges and bands hold many."""
    rng = np.random.default_rng(seed)
    m = rng.random((N, H, W)) < 0.002
    yy, xx = np.mgrid[:H, :W]
    for f in m:
        for _ in range(30):
            y, x, r = rng.integers(0, H), rng.integers(0, W), rng.integers(3, 41)
            f |= (yy - y) ** 2 + (xx - x) ** 2 <= r * r
        for _ in range(4):
            x = rng.integers(0, W - 2)
            f[rng.integers(0, H // 2):rng.integers(H // 2, H), x:x + 2] = True
    return m.astype(np.uint8) * 255


def check_band_ccl(mask, n, C, where):
    """KB's kernels on the n row bands of mask (N, H, W) uint8 on the card,
    read in place, against their plain versions on the same inputs, round
    by round (chip_smoke.py's kb_against_plain, which phase 7f runs: labels,
    piece values at the roots, root lists, snapshots, flags, tables and
    sums bit-equal), each kernel launched as often as the rounds ask.
    Returns the rounds."""
    from chip_smoke import KB_KERNELS, kb_against_plain

    before = {k: getattr(band_ccl, k).launches for k in KB_KERNELS}
    rounds = kb_against_plain(dict.fromkeys(KB_KERNELS, 0.0), mask, n, C, where)[3]
    torch.cuda.synchronize()
    got = {k: getattr(band_ccl, k).launches - v for k, v in before.items()}
    assert got == dict(band_labels=n, recon_edges=n * rounds, recon_min=n * rounds,
                       piece_table=n, piece_sums=n), got
    return rounds


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8], ids=["270_rows", "135_rows"])
@pytest.mark.parametrize("C", [32, 1500, 9000])
def test_band_ccl_kernels_match_plain(cuda_device, n, C):
    """KB on the bands of a 1080p mask batch, 270 rows (first rows even) or
    135 (odd first rows: labelled as a frame with one blank row above),
    C 32, past kb_sums's shared table (1500) and past kb_table's shared
    sort (9000)."""
    mask = torch.from_numpy(band_mask(3, 1080, 1920, seed=n + C)).to(cuda_device)
    assert check_band_ccl(mask, n, C, f"1080p, {n} bands, C {C}") >= 2


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["serpentine", "overflow"])
def test_band_ccl_kernels_scenes(cuda_device, scene):
    """The serpentine round by round (22 rounds) and the overflowing
    band (40 pieces, a table of 31 at C = 32) on 4 bands."""
    clip = serpentine_clip() if scene == "serpentine" else piece_overflow_clip()
    mask = torch.from_numpy((clip > 40).astype(np.uint8) * 255).to(cuda_device)
    rounds = check_band_ccl(mask, 4, 32, scene)
    assert rounds >= 15 if scene == "serpentine" else rounds >= 2


@pytest.mark.gpu
def test_kernels_launch_on_a_card_that_is_not_current(cuda_device):
    """K1 (both emits), K5 and the band CCL's KB on cuda:1 while cuda:0
    is the current device: every launch enters its tensors' card
    (_build.launch), the outputs stay there and equal the plain versions
    bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the launch must enter a card that is not current")
    other = torch.device("cuda", 1)
    frames, bg0 = scene(4, 200, 333, seed=9)
    diff_kw = dict(alpha=0.02, threshold=0.0, blur_ksize=5, emit="diff")
    dets, valid = det_sequence("churn", 8, frames=48, seed=2)
    kw = dict(max_dist=40.0, death_patience=3, assigner="hungarian")
    with torch.cuda.device(0):
        for opts in (BENCH, diff_kw):
            ref = fused_segment_plain(torch.from_numpy(frames), torch.from_numpy(bg0), **opts)
            got = fused_segment(torch.from_numpy(frames).to(other),
                                torch.from_numpy(bg0).to(other), **opts)
            torch.cuda.synchronize(other)
            assert torch.cuda.current_device() == 0
            for r, g in zip(ref, got):
                assert g.device == other
                np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())
        state = init_track_state(16, "cpu")
        ref = track_scan_plain(state, torch.from_numpy(dets), torch.from_numpy(valid),
                               torch.tensor(0, dtype=torch.int32), **kw)
        got = track_scan(TrackState(*(x.to(other) for x in state)),
                         torch.from_numpy(dets).to(other), torch.from_numpy(valid).to(other),
                         torch.tensor(0, dtype=torch.int32, device=other), **kw)
        torch.cuda.synchronize(other)
        for g, r in zip((*got[0], got[1], got[2]), (*ref[0], ref[1], ref[2])):
            assert g.device == other
            np.testing.assert_array_equal(_bits(g.cpu()).numpy(), _bits(r).numpy())
        mask = torch.from_numpy(band_mask(2, 270, 333, seed=4)).to(other)
        check_band_ccl(mask, 3, 16, "cuda:1")
        assert torch.cuda.current_device() == 0


# the register kernel's edges (T and D of 32 fit a lane each, 33 do not)
# and its array extents (D 8, 16 and 32)
K5_EDGES = [(32, 32), (32, 1), (1, 32), (33, 8), (16, 33), (33, 33), (2, 9), (31, 17)]


@pytest.mark.gpu
@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
@pytest.mark.parametrize("T,D", K5_EDGES, ids=[f"T{t}-D{d}" for t, d in K5_EDGES])
def test_track_scan_kernel_dispatch_edges(cuda_device, T, D, assigner):
    """Both kernels at the edges of the register kernel's shapes, each
    launch the one scan_plan names: a crowd (births at capacity where T <
    D), a contested stream (the Jonker-Volgenant search) and a cloud, 40
    frames from an empty table and 40 more near 2^24."""
    kw = dict(max_dist=40.0, death_patience=3, assigner=assigner)
    for kind in ("crowd", "contested", "cloud"):
        dets, valid = det_sequence(kind, D, frames=80, seed=T * 3 + D)
        ts, _rows, rv = check_track_scan(init_track_state(T, "cpu"), dets[:40], valid[:40], 0,
                                         cuda_device, **kw)
        check_track_scan(ts, dets[40:], valid[40:], 2**24 - 20, cuda_device, **kw)
        assert int(rv.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
def test_track_scan_kernel_global_scratch_matches_plain(cuda_device, assigner):
    """A table too large for a CTA's shared memory (T = 600, D = 100: the
    kernel's arrays take about 280 KB) takes the global-scratch
    instantiation; random clouds keep the Hungarian search on its slow
    path, transposed (T > D)."""
    kw = dict(max_dist=30.0, death_patience=2, assigner=assigner)
    dets, valid = det_sequence("cloud", 100, frames=8, seed=3)
    ts, _rows, rv = check_track_scan(init_track_state(600, "cpu"), dets, valid, 0, cuda_device, **kw)
    assert int(ts.active.sum()) > 100 and int(rv.sum()) > 100


# tables at the bench's shape, at the register kernel's edge, past it (the
# table kernel in shared memory) and past shared memory (global scratch)
K5_STREAM_TABLES = [(16, 8), (32, 32), (33, 40), (600, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
@pytest.mark.parametrize("T,D", K5_STREAM_TABLES, ids=[f"T{t}-D{d}" for t, d in K5_STREAM_TABLES])
def test_track_scan_kernel_streams_match_plain(cuda_device, T, D, assigner):
    """K5 with a stream axis, one launch for all streams (a CTA a stream),
    against its plain version on the CPU, bit for bit: each stream a
    different det_sequence kind, its own frame index (one near 2^24), 40
    frames from an empty table, then 40 from the states they leave."""
    kinds = ("churn", "contested", "crowd", "cloud", "empty") if T < 600 else ("cloud", "crowd")
    S, N = len(kinds), 40 if T < 600 else 8
    seqs = [det_sequence(k, D, frames=2 * N, seed=T + 7 * s) for s, k in enumerate(kinds)]
    dets = np.stack([d for d, _ in seqs])
    valid = np.stack([v for _, v in seqs])
    kw = dict(max_dist=40.0, death_patience=3, assigner=assigner)
    state = TrackState(*(torch.stack(x) for x in zip(*[init_track_state(T, "cpu")] * S)))
    frame0 = torch.tensor([5 + s for s in range(S - 1)] + [2**24 - N], dtype=torch.int32)
    for half in range(2):
        sl = slice(half * N, (half + 1) * N)
        ref = track_scan_plain(state, torch.from_numpy(dets[:, sl]), torch.from_numpy(valid[:, sl]),
                               frame0 + half * N, **kw)
        gpu_state = TrackState(*(x.to(cuda_device) for x in state))
        before = [x.clone() for x in gpu_state]
        launches = (track_scan.launches, track_scan.stream_launches)
        got = track_scan(gpu_state, torch.from_numpy(dets[:, sl]).to(cuda_device),
                         torch.from_numpy(valid[:, sl]).to(cuda_device),
                         (frame0 + half * N).to(cuda_device), **kw)
        torch.cuda.synchronize()
        assert (track_scan.launches, track_scan.stream_launches) == (launches[0] + 1,
                                                                     launches[1] + 1)
        for name, g, r in zip(TrackState._fields, got[0], ref[0]):
            np.testing.assert_array_equal(_bits(g).numpy(), _bits(r).numpy(), err_msg=name)
        np.testing.assert_array_equal(_bits(got[1]).numpy(), _bits(ref[1]).numpy(), err_msg="rows")
        np.testing.assert_array_equal(got[2].cpu().numpy(), ref[2].numpy(), err_msg="row_valid")
        assert all(torch.equal(a, b) for a, b in zip(gpu_state, before))
        state = ref[0]
    assert int(state.active.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", K1_REFUSED)
def test_configs_k1_refuses_run_on_the_card(cuda_device, name):
    """process_batch (through process_clip) and process_clip(use_pallas=True)
    on the card, one K5 launch a batch, and the CPU run's rows and masks:
    K1 a batch with K1b (one launch) or K1m (morph_plan's launches) beside
    it where k1_split takes the blur or the morphology out of its launch;
    for a median k > 3 the median route, K1b, K7 and K1 a batch (and for
    Otsu the tail's K1m)."""
    from tpuva_torch.ops.fused_segment import k1_split
    from tpuva_torch.ops.median import median_u8
    from tpuva_torch.ops.wide import morph_plan, open_close_steps
    from refimpl.synthetic import multi_blob_clip
    from tpuva_torch.graph.pipeline import _front_end_kwargs, process_clip

    frames, _alive, _truth, plate = multi_blob_clip(160, 240, 16, n_blobs=2, radius=46.0,
                                                    noise_sigma=2.0, seed=7)
    from tpuva_torch.graph import config as c

    cfg = k1_refused_config(c.PipelineConfig(
        background=c.BackgroundConfig(alpha=0.02), blur=c.BlurConfig(ksize=5, sigma=0.0),
        morph_open=c.MorphConfig(ksize=3, shape="rect"),
        morph_close=c.MorphConfig(ksize=3, shape="ellipse"),
        segment=c.SegmentConfig(threshold=35.0, min_area=50, max_blobs=8),
        track=c.TrackConfig(max_dist=80.0, death_patience=5, max_tracks=16, assigner="hungarian"),
        batch=8), name)
    ref = process_clip(frames, cfg, background0=plate, max_components=32, return_masks=True,
                       device="cpu")
    assert len(ref[0]) > 10
    median_k1 = cfg.median is None or cfg.median.ksize <= 3
    otsu_tail = cfg.segment.threshold == "otsu"
    kw = _front_end_kwargs(cfg)
    # the median route: K1b before K7, K1 with no blur, median or split
    blur_apart, morph_apart = k1_split(160, 240, **kw) if median_k1 else (True, otsu_tail)
    steps = open_close_steps(((kw["open_shape"], kw["open_ksize"], kw["open_iters"]),
                              (kw["close_shape"], kw["close_ksize"], kw["close_iters"])))
    n_morph = len(morph_plan(160, 240, steps)) if morph_apart else 0
    for use_pallas in (False, True):
        k1, k5, k7 = fused_segment.launches, track_scan.launches, median_u8.launches
        wide = blur_u8.launches, morph_u8.launches
        rows, carry, masks = process_clip(frames, cfg, background0=plate, max_components=32,
                                          return_masks=True, use_pallas=use_pallas, device="cuda")
        assert fused_segment.launches == k1 + 2
        assert track_scan.launches == k5 + 2
        assert median_u8.launches - k7 == (0 if median_k1 else 2)
        assert blur_u8.launches - wide[0] == 2 * blur_apart  # a launch a batch
        assert morph_u8.launches - wide[1] == 2 * n_morph
        assert rows == ref[0]
        np.testing.assert_array_equal(masks, ref[2])
        assert torch.equal(carry.bg.cpu(), ref[1].bg)


@pytest.mark.gpu
@pytest.mark.parametrize("ksize", [3, 5, 7, 9, 11, 13, 15, 21, 25, 51, 255, 257, 437])
def test_median_u8_kernel_matches_plain(cuda_device, ksize):
    """K7 against its plain versions on the card, bit for bit, one launch a
    call: the network kernels (k <= 9) and the sliding histogram (k >= 11;
    8-bit counts to 15, 16-bit to 255, 32-bit past), on a ragged batch (k
    <= 255), frames narrower or lower than the window, one row, one pixel,
    and a clip of uneven content; for every k also 1080-row frames of
    widths 1, 2, 3, 5, 37 and 1917 (no multiple of a block's columns or a
    16-byte load), the same widths on 9 rows, and the adversarial frames
    (constant, two values, 0/255, ramps, outliers) at 1080p. Those are
    held to median_u8_plain up to k = 25 and to median_u8_counts_plain
    past it, where the sort's window stack would not fit."""
    from tpuva_torch.ops.median import median_u8, median_u8_counts_plain, median_u8_plain

    rng = np.random.default_rng(ksize)
    shapes = [(2, 8, 300), (2, 300, 8), (2, 1, 50), (1, 1, 1)]
    if ksize <= 255:
        shapes.append((3, 70, 133))
    if ksize <= 25:
        shapes.append((4, 250, 333))
    wide = [(2, h, w) for h in (9, 1080) for w in (1, 2, 3, 5, 37)] + [(1, 1080, 1917)]
    frames = []
    for shape in shapes + wide:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        x[:, : shape[1] // 2] //= 8  # a dark half: many equal values in a window
        frames.append((shape, x, shape in wide))
    frames += [(name, x, True)
               for name, x in median_adversarial((2, 1080, 1920), seed=ksize).items()]
    for what, x, large in frames:
        x = torch.from_numpy(x).to(cuda_device)
        before = median_u8.launches
        got = median_u8(x, ksize)
        torch.cuda.synchronize()
        assert median_u8.launches == before + 1
        plain = median_u8_counts_plain if large and ksize > 25 else median_u8_plain
        assert torch.equal(got, plain(x, ksize)), what


@pytest.mark.gpu
@pytest.mark.parametrize("ksize", [3, 5, 7, 9, 11])
def test_median_hist_u8_matches_networks(cuda_device, ksize):
    """K7's histogram tier forced below its range (median_hist_u8, which
    the crossover timing runs) equals the networks and the plain version
    on a ragged batch, a one-row and a one-column frame, and the
    adversarial frames at 1080p; one launch a call, none of median_u8's."""
    from tpuva_torch.ops.median import median_hist_u8, median_u8, median_u8_plain

    rng = np.random.default_rng(ksize + 100)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8)
              for shape in ((3, 70, 133), (2, 1, 50), (2, 50, 1))]
    frames += list(median_adversarial((2, 1080, 1920), seed=ksize).values())
    for x in frames:
        x = torch.from_numpy(x).to(cuda_device)
        before = median_hist_u8.launches, median_u8.launches
        got = median_hist_u8(x, ksize)
        torch.cuda.synchronize()
        assert (median_hist_u8.launches, median_u8.launches) == (before[0] + 1, before[1])
        assert torch.equal(got, median_u8(x, ksize))
        assert torch.equal(got, median_u8_plain(x, ksize))


@pytest.mark.gpu
def test_median_hist_plan_matches_python(cuda_device):
    """csrc/median.cu's histogram plan (count bytes, threads, strip rows,
    shared bytes) equals ops/median.py::hist_plan at the card's SM count,
    from one frame to 256 at 1080p, on narrow and small frames, for k up
    to 437; every CTA an SM count is at least one."""
    import ctypes

    from tpuva_torch import _build
    from tpuva_torch.ops.median import HIST_MIN_K, hist_plan

    lib = _build.load()
    out = (ctypes.c_int * 7)()
    for N, H, W in ((256, 1080, 1920), (1, 1080, 1920), (4, 1080, 1917), (2, 9, 37), (1, 1, 1)):
        for k in (3, 11, 15, 17, 21, 255, 257, 437):
            _build.check(lib, lib.tpuva_median_hist_plan(N, H, W, k, out), "plan")
            plan = hist_plan(N, H, W, k, sms=out[4])
            assert list(out[:4]) == [plan[n] for n in ("count_bytes", "threads", "strip", "smem")]
            assert out[5] >= 1 and out[6] == HIST_MIN_K


@pytest.mark.gpu
@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_filter_median_launches_k7(cuda_device, color):
    """FilterMedian on uint8 launches K7 once a batch (a colour batch's
    channels folded into the leading axis) and equals the CPU's."""
    from tpuva_torch.ops.median import median_u8

    data = filter_clip(color=color)
    before = median_u8.launches
    got = list(tf.FilterMedian(VideoMemory(data), 7, device=cuda_device).iter_batches(4))
    assert median_u8.launches - before == 3
    ref = list(tf.FilterMedian(VideoMemory(data), 7, device="cpu").iter_batches(4))
    for (_n, a), (_m, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("ksize", [257, 437])
def test_median_blur_large_ksize_launches_k7(cuda_device, ksize):
    """median_blur on a uint8 tensor on the card launches K7 for a window
    past k = 255 too (no torch sort on the card for any k), and equals the
    CPU's."""
    from tpuva_torch.ops.filters import median_blur
    from tpuva_torch.ops.median import median_u8

    x = np.random.default_rng(ksize).integers(0, 256, (2, 3, 9, 70), dtype=np.uint8)
    before = median_u8.launches
    got = median_blur(torch.from_numpy(x).to(cuda_device), ksize)
    torch.cuda.synchronize()
    assert median_u8.launches - before == 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  median_blur(torch.from_numpy(x), ksize).numpy())


PROBES = {m.__name__.rsplit(".", 1)[1]: m for m in (repos_probe, roll_probe, i16_probe, cell_probe)}


@pytest.mark.gpu
@pytest.mark.parametrize("probe, case", [(p, c.name) for p, m in PROBES.items() for c in m.CASES])
def test_probe_kernel_matches_plain(cuda_device, probe, case):
    mod = PROBES[probe]
    x = mod.make_tile().to(cuda_device)
    for reps in mod.CHECK_REPS:
        before = mod.run.launches
        got = mod.run(x, case, reps)
        torch.cuda.synchronize()
        assert mod.run.launches == before + 1
        assert torch.equal(got, mod.plain(x, case, reps)), f"{probe} {case} at {reps} reps"
        if probe == "roll_probe" and reps == 140 and case in ("add f+f", "roll0 + add"):
            assert (got == 255).any()  # the doubling cases passed float32 overflow
        if probe == "i16_probe" and case == "int16" and reps > 1:
            assert not torch.equal(got, mod.run(x, "int32", reps))  # the int16 sums wrapped


@pytest.mark.gpu
def test_probe_kernel_time_grows_with_reps(cuda_device):
    """Every rep does its work: at counts where the launch is a small share,
    four times the reps take more than twice the time."""
    x = roll_probe.make_tile().to(cuda_device)
    t = {reps: timeit(lambda: roll_probe.run(x, "roll0 + add", reps), cuda_device)[0]
         for reps in (4096, 16384)}
    assert t[16384] > 2 * t[4096], t


# ------------------------------------------------------------- the filter chain
def filter_clip(T=9, H=67, W=131, color=False, seed=11):
    shape = (T, H, W, 3) if color else (T, H, W)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# the filters of tpuva_torch.filters on the card (each against the CPU's)
CARD_FILTERS = {
    "crop": (lambda tf, v, d: tf.FilterCrop(v, (3, 5, 101, 47), device=d), (False, True)),
    "monochrome": (lambda tf, v, d: tf.FilterMonochrome(v, device=d), (True,)),
    "resize": (lambda tf, v, d: tf.FilterResize(v, (65, 100), device=d), (False, True)),
    "blur_float": (lambda tf, v, d: tf.FilterBlur(tf.FilterNormalize(v, device=d), 1.5, 9),
                   (False, True)),
    "median_5": (lambda tf, v, d: tf.FilterMedian(v, 5, device=d), (False, True)),
    "time_difference": (lambda tf, v, d: tf.FilterTimeDifference(v, device=d), (False, True)),
    "rotate_angle": (lambda tf, v, d: tf.FilterRotate(v, angle=7.5, device=d), (False, True)),
    "warp": (lambda tf, v, d: tf.FilterWarpAffine(
        v, [[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]], out_size=(90, 50), border_value=9, device=d),
             (False, True)),
    "flip_turns": (lambda tf, v, d: tf.FilterFlip(tf.FilterRotate(v, turns=1, device=d)),
                   (False, True)),
    "background_float": (lambda tf, v, d: tf.FilterBackground(tf.FilterNormalize(v, device=d)),
                         (False,)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_FILTERS))
def test_filters_on_card_equal_cpu(cuda_device, name):
    make, colors = CARD_FILTERS[name]
    for color in colors:
        data = filter_clip(color=color)
        got = list(make(tf, VideoMemory(data), cuda_device).iter_batches(4, pad_last=True))
        ref = list(make(tf, VideoMemory(data), "cpu").iter_batches(4, pad_last=True))
        assert [n for n, _ in got] == [n for n, _ in ref]
        for (_n, a), (_m, b) in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_filter_blur_u8_launches_k1b(cuda_device, color):
    """FilterBlur on uint8 launches K1b once a batch (a colour batch's
    channels folded into the leading axis) and equals the CPU's."""
    data = filter_clip(color=color)
    before = blur_u8.launches
    got = list(tf.FilterBlur(VideoMemory(data), 0.0, 7, device=cuda_device).iter_batches(4))
    assert blur_u8.launches - before == 3
    ref = list(tf.FilterBlur(VideoMemory(data), 0.0, 7, device="cpu").iter_batches(4))
    for (_n, a), (_m, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_filter_background_launches_k1_diff(cuda_device):
    """FilterBackground on uint8 launches K1's diff emit once a batch, the
    background carried on the card, and equals the CPU's."""
    data = filter_clip(T=11)
    before = fused_segment.launches
    got = list(tf.FilterBackground(VideoMemory(data), 0.05, device=cuda_device).iter_batches(4))
    assert fused_segment.launches - before == 3
    ref = list(tf.FilterBackground(VideoMemory(data), 0.05, device="cpu").iter_batches(4))
    for (_n, a), (_m, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_mask_boundary_launches_k1m(cuda_device):
    m = filter_clip(T=3) > 100
    before = morph_u8.launches
    got = mask_boundary(torch.from_numpy(m).to(cuda_device))
    assert morph_u8.launches - before == 1
    np.testing.assert_array_equal(got.cpu().numpy(), mask_boundary(torch.from_numpy(m)).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("use_native", [False, True])
def test_batch_stager_runs_chain_on_card(cuda_device, use_native):
    """A BGR chain staged by its root: the chain's program once a batch on
    the card (K1b and K1's diff emit each once a batch), the CPU stager's
    batches bit for bit."""
    data = filter_clip(T=11, color=True)

    def chain(d):
        return tf.FilterBackground(tf.FilterBlur(tf.FilterMonochrome(
            VideoMemory(data), device=d), 0.0, 5), 0.05)

    def stage(d, native):
        st = BatchStager(chain(d), 4, device=d, use_native=native)
        try:
            return [(n, b.cpu().numpy()) for n, b in st]
        finally:
            st.close()

    k1, k1b, runs = fused_segment.launches, blur_u8.launches, tf.run_chain.runs
    got = stage(cuda_device, use_native)
    assert (fused_segment.launches - k1, blur_u8.launches - k1b, tf.run_chain.runs - runs) == (
        3, 3, 3)
    ref = stage("cpu", False)
    assert [n for n, _ in got] == [n for n, _ in ref] == [4, 4, 3]
    for (_n, a), (_m, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ------------------------------------- KE, KM, KW, KR (csrc/distance.cu, csrc/filters.cu)
def random_masks(shape, densities, seed):
    rng = np.random.default_rng(seed)
    return np.stack([(rng.random(shape) < d).astype(np.uint8) for d in densities])


def check_edt(mask, launches=1):
    """KE's squared EDT, its EDT and its pass counts against the plain loop
    on the card, `launches` launches a call."""
    before = distance.edt_kernel.launches
    sq, passes = distance.edt_sq_passes(mask)
    d = distance.distance_transform_edt(mask)
    assert distance.edt_kernel.launches - before == 2 * launches
    ref, ref_passes = distance.edt_sq_passes_plain(mask)
    assert sq.dtype == d.dtype == torch.float32
    assert torch.equal(sq, ref) and passes == ref_passes
    assert torch.equal(d, torch.sqrt(ref))
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(edt_scenes()))
def test_edt_kernel_matches_plain_on_scenes(cuda_device, name):
    m = torch.from_numpy(edt_scenes()[name]).to(cuda_device)
    for x in (m, m.to(torch.bool), m.to(torch.float32)):
        check_edt(x)


@pytest.mark.gpu
def test_edt_kernel_matches_plain_at_1080p(cuda_device):
    """Random 1080p masks at densities 0.02 to 0.995, an all-foreground
    (+inf) and an all-background frame."""
    m = random_masks((1080, 1920), (0.02, 0.5, 0.9, 0.995), seed=21)
    m = np.concatenate([m, np.ones((1, 1080, 1920), np.uint8), np.zeros((1, 1080, 1920),
                                                                        np.uint8)])
    x = torch.from_numpy(m).to(cuda_device)
    check_edt(x)
    assert torch.isinf(distance.distance_transform_edt_sq(x[4])).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["single_zero_4096x94", "single_zero_2898x2898", "tall_5000x3",
                                  "motion_4320x7680", "rows_3x25600", "rows_3x28672",
                                  "row_1x70000", "masks_65536x5x7"])
def test_edt_kernel_matches_plain_past_4096(cuda_device, name):
    """KE at sizes the parent refused or rounded differently: the F3 masks
    (sums past 2^24: the row loop's rounding tier), column distances past
    4096 (the f table), 8K UHD, the widest row in shared memory (a band of
    one row: 9 W bytes) and rows past it (global rows), 65,536 masks (two
    launches a call)."""
    m = torch.from_numpy(edt_large_scenes()[name]).to(cuda_device)
    ref = check_edt(m, launches=2 if name.startswith("masks_") else 1)
    if name == "single_zero_4096x94":
        assert ref[4095, 93].item() == 16_777_672
    if name == "tall_5000x3":
        f = distance.f_table(5000)[4999]
        assert ref[4999, 1].item() == f and int(f) != 4999**2
    if name == "rows_3x25600":
        assert ref[0].max().item() >= 2**24
    if name in ("single_zero_2898x2898", "row_1x70000"):
        assert ref.max().item() >= 2**24


def bgr_frames(shape, seed, dtype=np.uint8):
    """Random BGR (three independent channels: equal ones would hide a
    wrong weight order)."""
    x = np.random.default_rng(seed).integers(0, 256, shape).astype(dtype)
    if dtype == np.float32:
        x += np.random.default_rng(seed + 1).random(shape, dtype=np.float32)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "float32", "int16"])
def test_bgr_to_gray_kernel_matches_plain(cuda_device, dtype):
    """KM on random BGR: whole pieces with and without a tail, one pixel,
    slices whose start is not 16-byte aligned (the pixel path), 1080p; one
    launch a call."""
    for shape in ((2, 7, 11, 3), (1, 4, 4, 3), (1, 1, 1, 3), (3, 33, 65, 3), (4, 1080, 1920, 3)):
        x = torch.from_numpy(bgr_frames(shape, 4, np.dtype(dtype).type)).to(cuda_device)
        views = [x, x.reshape(-1)[3:].reshape(-1, 3)[:-1]]  # 3 elements in
        for v in views[: 1 if x.numel() <= 3 else 2]:
            before = color.bgr_to_gray.launches
            got = color.bgr_to_gray(v)
            assert color.bgr_to_gray.launches - before == 1
            ref = color.bgr_to_gray_plain(v)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (shape, dtype)


KW_CASES = {
    "rotate": dict(M=warp.rotation_matrix((26.0, 18.0), 7.5)),
    "shear_out_size": dict(M=[[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]], out_size=(40, 30),
                           border_value=17.0),
    "inverse": dict(M=[[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]], inverse=True),
    "replicate": dict(M=warp.rotation_matrix((20.0, 11.0), -33.0, 1.2), border="replicate"),
    "upscale_replicate": dict(M=[[1.7, 0.0, -4.0], [0.0, 1.3, 2.0]], out_size=(71, 45),
                              border="replicate"),
    "far_out": dict(M=[[1e6, 0.0, -4e9], [0.0, -3e5, 2e9]], out_size=(20, 10), border_value=3.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(KW_CASES))
def test_warp_affine_kernel_matches_plain(cuda_device, name):
    """KW on (N, H, W), (H, W), (N, H, W, 3), (H, W, 3), uint8 and float32,
    against its plain version on the card; one launch a call."""
    kw = KW_CASES[name]
    for shape in ((4, 37, 53), (37, 53), (3, 37, 53, 3), (37, 53, 3)):
        for dtype in (np.uint8, np.float32):
            x = torch.from_numpy(bgr_frames(shape, 5, dtype)).to(cuda_device)
            before = warp.warp_affine.launches
            got = warp.warp_affine(x, **kw)
            assert warp.warp_affine.launches - before == 1
            ref = warp.warp_affine_plain(x, **kw)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (shape, dtype)


@pytest.mark.gpu
def test_warp_affine_kernel_matches_plain_at_1080p(cuda_device):
    M = warp.rotation_matrix((959.5, 539.5), 7.5)
    for shape in ((4, 1080, 1920), (2, 1080, 1920, 3)):
        x = torch.from_numpy(bgr_frames(shape, 6)).to(cuda_device)
        for kw in (dict(), dict(out_size=(1600, 900), border_value=7.0),
                   dict(border="replicate")):
            assert torch.equal(warp.warp_affine(x, M, **kw), warp.warp_affine_plain(x, M, **kw))


@pytest.mark.gpu
def test_latency_probe_kernel_matches_plain(cuda_device):
    """Each latency-probe case bit-equal to its plain version, one launch a
    call, and its time grows with the reps."""
    x = latency_probe.make_tile().to(cuda_device)
    for case in latency_probe.CASES:
        for reps in latency_probe.CHECK_REPS:
            before = latency_probe.run.launches
            got = latency_probe.run(x, case.name, reps)
            assert latency_probe.run.launches - before == 1
            assert torch.equal(got.cpu(), latency_probe.plain(x.cpu(), case.name, reps)), case
    assert all(ns > 0 for ns in latency_probe.measure(cuda_device, iters=1).values())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["shared", "direct"])
def test_warp_affine_kernel_routes(cuda_device, route):
    """KW's two routes at 1080p, each bit-equal to the plain version: under
    FilterRotate(angle=7.5)'s map every uint8 tile (and float32 gray tile)
    stages its footprint in shared memory; under a 4x down-scale the tiles
    gather from global memory (all but the short bottom row of tiles). The
    routes cover the tiles once."""
    if route == "shared":
        kw = dict(M=warp.rotation_matrix((959.5, 539.5), 7.5))
    else:
        kw = dict(M=[[0.25, 0.0, 3.0], [0.0, 0.25, 1.0]], out_size=(480, 270), border_value=5.0)
    for shape in ((3, 1080, 1920), (2, 1080, 1920, 3)):
        for dtype in (np.uint8, np.float32):
            x = torch.from_numpy(bgr_frames(shape, 8, dtype)).to(cuda_device)
            got, (staged, direct) = warp.warp_affine_routes(x, **kw)
            assert torch.equal(got, warp.warp_affine_plain(x, **kw)), (shape, dtype)
            plan = warp.warp_plan(x.shape, kw["M"], kw.get("out_size"))
            tw, th = warp.KW_TILE
            assert staged + direct == -(-plan.wo // tw) * -(-plan.ho // th)
            if route == "direct":
                assert direct > 0
            elif dtype == np.uint8 or len(shape) == 3:
                assert direct == 0


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(26, 18), (80, 37), (53, 55), (53, 37), (1, 1),
                                  (960, 540), (2880, 1620)])
def test_resize_linear_kernel_matches_plain(cuda_device, size):
    """KR on random gray and BGR, uint8 and float32, down, up, one axis
    kept, both kept; 1080p for the phase's two sizes; one launch a call."""
    shapes = ((3, 37, 53), (2, 37, 53, 3)) if size[0] < 100 else ((2, 1080, 1920),
                                                                   (1, 1080, 1920, 3))
    for shape in shapes:
        for dtype in (np.uint8, np.float32):
            x = torch.from_numpy(bgr_frames(shape, 7, dtype)).to(cuda_device)
            before = resize.resize_linear.launches
            got = resize.resize_linear(x, size)
            assert resize.resize_linear.launches - before == 1
            ref = resize.resize_linear_plain(x, size)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (shape, dtype)


# KR's routes: (shape, dtype, size, byte offset of the input view)
KR_ROUTE_CASES = {
    "gather_1920_to_61": ((2, 1080, 1920, 3), np.uint8, (61, 540), 0),
    "gather_gray_float": ((2, 1080, 1920), np.float32, (61, 270), 0),
    "offset_1_bgr": ((2, 1080, 1920, 3), np.uint8, (960, 540), 1),
    "offset_1_gray_up": ((3, 37, 53), np.uint8, (80, 37), 1),
    "rows_not_16_bytes": ((3, 37, 53, 3), np.uint8, (26, 18), 0),
    "rows_not_16_bytes_gray": ((3, 45, 301), np.uint8, (7, 90), 0),
    "float32_bgr_960x540": ((2, 1080, 1920, 3), np.float32, (960, 540), 0),
    "float32_up": ((2, 37, 53, 3), np.float32, (80, 55), 0),
    "staged_960x540": ((16, 1080, 1920, 3), np.uint8, (960, 540), 0),
    "staged_gray_2880x1620": ((2, 1080, 1920), np.uint8, (2880, 1620), 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(KR_ROUTE_CASES))
def test_resize_linear_kernel_routes(cuda_device, name):
    """KR's two routes bit-equal to the plain version, with the tiles of
    each route as resize_plan counts them: tiles gathering where 64 output
    columns span more than a buffer (1920 -> 61 wide), an input view at a
    byte offset of 1 and rows that are not 16-byte multiples (byte copies,
    byte stores), float32, every tile staged at the phase's sizes."""
    shape, dtype, size, offset = KR_ROUTE_CASES[name]
    data = torch.from_numpy(bgr_frames(shape, 9, dtype)).to(cuda_device)
    if offset:  # uint8 cases: a contiguous view one byte into its buffer
        x = torch.empty(data.numel() + offset, dtype=torch.uint8, device=cuda_device)[offset:]
        x = x.view(shape).copy_(data)
        assert x.data_ptr() % 16 == offset
    else:
        x = data
    before = resize.resize_linear.launches
    got, (staged, direct) = resize.resize_linear_routes(x, size)
    assert resize.resize_linear.launches - before == 1
    ref = resize.resize_linear_plain(x, size)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    px = (shape[3] if len(shape) == 4 else 1) * data.element_size()
    vec_in = (shape[2] * px) % 16 == 0 and x.data_ptr() % 16 == 0
    plan = resize.resize_plan(shape[0], shape[1], shape[2], px, size, vec_in)
    assert (staged, direct) == (int(plan.staged.sum()), int((~plan.staged).sum()))
    if name.startswith("gather"):
        assert direct > 0
    if name.startswith(("staged", "offset", "float32")):
        assert direct == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["monochrome", "resize", "rotate_angle", "warp"])
def test_filter_launches_its_kernel_once_a_batch(cuda_device, name):
    """FilterMonochrome (KM), FilterResize (KR), FilterRotate(angle=) and
    FilterWarpAffine (KW) launch their kernel once a batch on the card and
    equal the CPU's."""
    make, colors = CARD_FILTERS[name]
    counter = {"monochrome": color.bgr_to_gray, "resize": resize.resize_linear}.get(
        name, warp.warp_affine)
    for c in colors:
        data = filter_clip(color=c)
        before = counter.launches
        got = list(make(tf, VideoMemory(data), cuda_device).iter_batches(4))
        assert counter.launches - before == 3
        ref = list(make(tf, VideoMemory(data), "cpu").iter_batches(4))
        for (_n, a), (_m, b) in zip(got, ref):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------- KS (the float background)
KS_SHAPES = [(n, 37, 53) for n in (1, 2, 3, 7, 16, 255, 256, 257)] + [(5, 250, 333), (4, 120, 1),
                                                                       (1024, 5, 7), (2000, 3, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", KS_SHAPES, ids=["x".join(map(str, s)) for s in KS_SHAPES])
def test_background_scan_kernel_matches_plain(cuda_device, shape):
    """KS's scanned order (background_scan, order "scan") against its plain
    version, bit for bit, on uint8 and float32 frames, both emits, from a
    background and seeded (a bool, and a flag on the card): N odd and even,
    past a CTA's shared memory at 2000 (the global scratch)."""
    rng = np.random.default_rng(shape[0])
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    bg0 = torch.from_numpy(rng.uniform(0, 255, shape[1:]).astype(np.float32)).to(cuda_device)
    flag = torch.ones((), dtype=torch.bool, device=cuda_device)
    for frames in (u8, u8.astype(np.float32) + rng.random(shape, dtype=np.float32)):
        f = torch.from_numpy(frames).to(cuda_device)
        for emit, thr in (("mask", 35.0), ("diff", None)):
            for seed in (False, True, flag):
                before = bgo.background_scan.launches
                got = bgo.background_scan(f, bg0, 0.02, seed, "scan", emit, thr)
                assert bgo.background_scan.launches - before == 1
                ref = bgo.background_scan_plain(f, bg0, 0.02, seed, "scan", emit, thr)
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [0.02, 0.3])
def test_background_scan_sequential_kernel_matches_plain(cuda_device, alpha):
    """KS's sequential order against its plain version, bit for bit, on
    float frames in [0, 1] and uint8, both emits, seeded by a flag."""
    rng = np.random.default_rng(5)
    flag = torch.ones((), dtype=torch.bool, device=cuda_device)
    bg0 = torch.rand((67, 131), device=cuda_device)
    for f in (torch.rand((9, 67, 131), device=cuda_device),
              torch.from_numpy(rng.integers(0, 256, (9, 67, 131), dtype=np.uint8)).to(cuda_device)):
        for emit, thr in (("mask", 0.25), ("diff", None)):
            for seed in (False, flag):
                before = bgo.background_scan.sequential_launches
                got = bgo.background_scan(f, bg0, alpha, seed, "sequential", emit, thr)
                assert bgo.background_scan.sequential_launches - before == 1
                ref = bgo.background_scan_plain(f, bg0, alpha, seed, "sequential", emit, thr)
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [35.0, "otsu"], ids=["fixed", "otsu"])
def test_scanned_route_on_card_equals_cpu(cuda_device, threshold):
    """process_batch(parallel_bg=True) on the card: KS once a batch, K1
    never; its masks, rows and background equal the CPU's, seeded and
    carried over three batches."""
    from tpuva_torch.graph import config as c
    from tpuva_torch.graph.pipeline import init_carry, process_batch

    frames, _bg0 = scene(48, 64, 96, 26)
    cfg = c.PipelineConfig(
        background=c.BackgroundConfig(alpha=0.02), blur=c.BlurConfig(ksize=5, sigma=0.0),
        morph_open=c.MorphConfig(ksize=3, shape="rect"),
        morph_close=c.MorphConfig(ksize=3, shape="ellipse"),
        segment=c.SegmentConfig(threshold=threshold, min_area=20, max_blobs=8),
        track=c.TrackConfig(max_dist=80.0, death_patience=5, max_tracks=16, assigner="hungarian"),
        batch=16)
    carries = {d: init_carry(cfg, 64, 96, device=d) for d in (cuda_device, "cpu")}
    for start in range(0, 48, 16):
        outs = {}
        before = (bgo.background_scan.launches, fused_segment.launches)
        for d in (cuda_device, "cpu"):
            carries[d], outs[d] = process_batch(cfg, carries[d],
                                                torch.from_numpy(frames[start:start + 16]).to(d),
                                                parallel_bg=True, return_masks=True)
        assert bgo.background_scan.launches - before[0] == 1
        assert fused_segment.launches == before[1]
        for k in ("masks", "rows", "row_valid", "n_det"):
            assert torch.equal(outs[cuda_device][k].cpu(), outs["cpu"][k]), k
        assert torch.equal(carries[cuda_device].bg.cpu(), carries["cpu"].bg)


# ------------------------------------------------------ KG (the float blur)
KG_CASES = [(3, 0.0), (5, 0.0), (7, 0.0), (9, 1.5), (11, 0.0), (31, 0.0), (121, 0.0), (231, 0.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("ksize,sigma", KG_CASES)
def test_gaussian_blur_kernel_matches_plain(cuda_device, ksize, sigma):
    """KG against gaussian_blur_plain, bit for bit, on non-integer frames:
    (N, H, W) and (N, H, W, 3) with the channels interleaved, tiles cut at
    the edges, one column, one row, H below the radius; past shared memory
    (121 BGR, 231 gray) the direct route. One launch a call."""
    rng = np.random.default_rng(ksize)
    for shape in ((3, 67, 131), (2, 5, 1), (2, 1, 40), (2, 4, 70), (1, 300, 9)):
        for channels_last in (False, True):
            x = rng.random(shape + ((3,) if channels_last else ()), dtype=np.float32)
            xt = torch.from_numpy(x).to(cuda_device)
            before = gaussian_blur.launches
            got = gaussian_blur(xt, ksize, sigma, channels_last)
            assert gaussian_blur.launches - before == 1
            ref = gaussian_blur_plain(xt, ksize, sigma, channels_last)
            assert torch.equal(got, ref), (shape, channels_last)


@pytest.mark.gpu
@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_filter_blur_float_launches_kg(cuda_device, color):
    """FilterBlur on float frames (after FilterNormalize) launches KG once a
    batch, the colour batch as it lies, and equals the CPU's."""
    data = filter_clip(color=color)
    before = gaussian_blur.launches

    def chain(device):
        return tf.FilterBlur(tf.FilterNormalize(VideoMemory(data), device=device), 1.5, 9)

    got = list(chain(cuda_device).iter_batches(4))
    assert gaussian_blur.launches - before == 3
    for (_n, a), (_m, b) in zip(got, list(chain("cpu").iter_batches(4))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_filter_background_float_launches_ks(cuda_device):
    """FilterBackground on float frames launches KS's sequential order once
    a batch, the background carried on the card, and equals the CPU's."""
    data = filter_clip(T=11)
    before = bgo.background_scan.sequential_launches

    def chain(device):
        return tf.FilterBackground(tf.FilterNormalize(VideoMemory(data), device=device), 0.05)

    got = list(chain(cuda_device).iter_batches(4))
    assert bgo.background_scan.sequential_launches - before == 3
    for (_n, a), (_m, b) in zip(got, list(chain("cpu").iter_batches(4))):
        np.testing.assert_array_equal(a, b)
