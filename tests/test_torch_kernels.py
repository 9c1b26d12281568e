"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so it runs where the card is (the tests/
conftest.py imports JAX, so skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu -q

Without a CUDA device every test here skips: a CUDA kernel has no CPU
mode. Kernel and plain version are compared bit for bit (masks, float32
background, every stats field): both are the same integer and IEEE
float32 operation sequences. The scene builders are shared with the
CPU tests that hold the plain versions against tpuva.
"""

import numpy as np
import pytest
import torch

from tpuva_torch.ops.ccl import label_stats
from tpuva_torch.ops.fused_segment import fused_segment, fused_segment_plain

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


def u_shape(H, W):
    """One component running right, down and back left across tiles."""
    m = np.zeros((H, W), np.uint8)
    m[10:14, 20:W - 10] = 255
    m[10:H - 10, W - 20:W - 10] = 255
    m[H - 20:H - 10, 30:W - 10] = 255
    return m


def mixed_scene():
    """One batch, one shape: random, empty, tile-straddling blobs, a U
    across tiles, and more components than C."""
    rng = np.random.default_rng(3)
    H, W = 130, 280
    m = np.zeros((5, H, W), np.uint8)
    m[0] = (rng.random((H, W)) < 0.25) * 255
    m[2, 60:70, 250:265] = 255  # crosses a 256-column border
    m[2, 62:66, 10:30] = 255
    m[2, 126:130, 0:8] = 255  # image edge, unaligned H
    m[2, 63:65, 120:200] = 255  # crosses a 64-row border
    m[3] = u_shape(H, W)
    m[4, 5:H:6, 5:W:7] = 255  # 21 x 40 isolated dots
    return m


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
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_segment_kernel_matches_plain(cuda_device, name):
    kw = CONFIGS[name]
    for shape in [(5, 64, 256), (4, 50, 100), (3, 250, 333), (2, 7, 5)]:
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
