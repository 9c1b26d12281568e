"""The port's Otsu route against tpuva's on the CPU, bit for bit.

Same numpy inputs through tpuva (JAX on the CPU; the Pallas kernels in
interpret mode) and through the port with device="cpu" (each kernel's
plain version): the histogram (K4's plain version) and the Otsu threshold,
K1's emit="diff", then every entry point with SegmentConfig(threshold=
"otsu") — process_batch with both background forms, process_batch_staged,
process_clip and StreamingPipeline with a stop and a resume.

Masks, magnitudes, thresholds and rows are compared exactly (==). The
final background is held to rtol 1e-5, as in the other port tests: the
port keeps the contract's two roundings, XLA:CPU contracts tpuva's update
into an FMA (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuva.graph.pipeline as jp
import tpuva.graph.streaming as js
import tpuva.io.memory as jio_memory
import tpuva.ops.filters as jf
from refimpl.synthetic import moving_disk_clip
from tpuva.export.csvio import format_rows as jax_format_rows
from tpuva.graph.config import (
    BackgroundConfig, BlurConfig, MorphConfig, PipelineConfig, SegmentConfig, TrackConfig,
)
from tpuva.ops.pallas.fused_segment import fused_segment as jax_fused
from tpuva_torch.export.csvio import format_rows
from tpuva_torch.graph import pipeline as tp
from tpuva_torch.graph.streaming import StreamingPipeline
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.ops import filters as tf
from tpuva_torch.ops.fused_segment import fused_segment, fused_segment_plain
from test_torch_fused_segment import _jax_filtered, contract_bg
from test_torch_kernels import CONFIGS, one_torch_thread, scene  # noqa: F401

CPU = dict(device="cpu")
OTSU_CFG = PipelineConfig(
    background=BackgroundConfig(alpha=0.05),
    blur=BlurConfig(ksize=5, sigma=0.0),
    morph_open=MorphConfig(ksize=3, shape="rect"),
    segment=SegmentConfig(threshold="otsu", min_area=20, max_blobs=4),
    track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
    batch=8,
)
DIFF_CONFIGS = {  # K1's front end without morphology, as emit="diff" takes it
    name: {k: v for k, v in CONFIGS[name].items()
           if k in ("alpha", "blur_ksize", "blur_sigma", "median_ksize")}
    for name in CONFIGS
}


def synthetic_histograms(n, seed, P=1080 * 1920):
    """n (256,) float32 histograms of 1080p totals: a half-normal
    background of small |F - B| magnitudes and a normal foreground
    holding 10-70% of the pixels, drawn as multinomial counts."""
    rng = np.random.default_rng(seed)
    v = np.arange(256)
    out = np.empty((n, 256), np.float32)
    for i in range(n):
        fg = rng.uniform(0.1, 0.7)
        pb = np.exp(-0.5 * (v / rng.uniform(1, 6)) ** 2)
        pf = np.exp(-0.5 * ((v - rng.uniform(20, 200)) / rng.uniform(3, 40)) ** 2)
        out[i] = rng.multinomial(P, (1 - fg) * pb / pb.sum() + fg * pf / pf.sum())
    return out


def naive_otsu(hist):
    """otsu_from_histogram with torch.cumsum's order instead of XLA:CPU's."""
    total = hist.sum(-1, keepdim=True)
    bins = torch.arange(256, dtype=torch.float32)
    w0, sum0 = torch.cumsum(hist, -1), torch.cumsum(hist * bins, -1)
    w1 = total - w0
    mu0 = sum0 / torch.clamp(w0, min=1)
    mu1 = (sum0[..., -1:] - sum0) / torch.clamp(w1, min=1)
    var = w0 * w1 * ((mu0 - mu1) * (mu0 - mu1))
    return torch.argmax(torch.where((w0 > 0) & (w1 > 0), var, -1.0), -1).to(torch.float32)


@pytest.mark.parametrize("shape", [(3, 40, 64), (5, 250, 333), (2, 2, 3, 7), (1, 1, 1)])
def test_histogram_u8_matches_tpuva(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    x.reshape(-1)[: x.size // 3] = 2  # one heavy bin, as |F - B| magnitudes have
    before = tf.histogram_u8.launches
    got = tf.histogram_u8(torch.from_numpy(x))
    assert tf.histogram_u8.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == shape[:-2] + (256,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.histogram_u8(jnp.asarray(x))))
    assert float(got.sum()) == x.size


def test_otsu_from_histogram_matches_tpuva_on_1080p_histograms():
    """400 histograms whose partial sums of count * bin pass 2^24 and
    round: the threshold then depends on the order of the cumulative sums.
    Bit-equal to tpuva's, and the companion check shows that torch.cumsum's
    order would not be: the test guards the order."""
    hist = synthetic_histograms(400, seed=1)
    ref = np.asarray(jf.otsu_from_histogram(jnp.asarray(hist)))
    got = tf.otsu_from_histogram(torch.from_numpy(hist))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (naive_otsu(torch.from_numpy(hist)).numpy() != ref).sum() > 0
    # the cumulative sum itself, on rows of mixed magnitude
    rows = np.random.default_rng(2).standard_normal((300, 256)).astype(np.float32)
    rows *= (np.float32(10) ** (np.arange(300) % 7)).astype(np.float32)[:, None]
    np.testing.assert_array_equal(tf._cumsum256(torch.from_numpy(rows)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(rows), -1)))


def test_float32_otsu_is_not_cv2_at_1080p():
    """ROADMAP Queue 3: tpuva's float32 rule, which the port carries bit
    for bit, is not cv2.THRESH_OTSU (float64) once a frame is large: on
    1080p totals the two pick different thresholds for some histograms;
    on small images (partial sums below 2^24) they agree."""
    import cv2

    def cv2_otsu(hist, shape):
        img = np.repeat(np.arange(256, dtype=np.uint8), hist.astype(np.int64)).reshape(shape)
        return cv2.threshold(img, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)[0]

    for P, shape, want_differ in ((1080 * 1920, (1080, 1920), True), (64 * 96, (64, 96), False)):
        hist = synthetic_histograms(40, seed=1, P=P)
        port = tf.otsu_from_histogram(torch.from_numpy(hist)).numpy()
        np.testing.assert_array_equal(port, np.asarray(jf.otsu_from_histogram(jnp.asarray(hist))))
        differ = sum(port[i] != cv2_otsu(h, shape) for i, h in enumerate(hist))
        assert (differ > 0) == want_differ, (shape, differ)


def test_otsu_from_histogram_edges():
    """All mass in one bin, two equal peaks (the argmax tie takes the
    lowest threshold), an empty histogram, small random ones."""
    hists = []
    for b in (0, 17, 255):
        h = np.zeros(256, np.float32)
        h[b] = 1000
        hists.append(h)
    for lo, hi in ((10, 200), (0, 255), (100, 101)):
        h = np.zeros(256, np.float32)
        h[lo] = h[hi] = 500
        hists.append(h)
    hists.append(np.zeros(256, np.float32))
    hists += list(np.random.default_rng(3).integers(0, 50, (20, 256)).astype(np.float32))
    hist = np.stack(hists)
    ref = np.asarray(jf.otsu_from_histogram(jnp.asarray(hist)))
    np.testing.assert_array_equal(tf.otsu_from_histogram(torch.from_numpy(hist)).numpy(), ref)
    assert list(ref[3:6]) == [10.0, 0.0, 100.0]  # the lower of the tied splits


def test_otsu_threshold_matches_tpuva():
    rng = np.random.default_rng(4)
    x = np.clip(np.abs(rng.normal(0, 3, (4, 30, 50))), 0, 255).astype(np.uint8)
    x[:, 10:20, 10:30] = rng.integers(40, 90, (4, 10, 20))
    np.testing.assert_array_equal(tf.otsu_threshold(torch.from_numpy(x)).numpy(),
                                  np.asarray(jf.otsu_threshold(jnp.asarray(x))))


def _rounded_diff(filtered, bg0, alpha, fma):
    """clip(rint(|F - B|)) per frame of the float32 background recurrence:
    the pinned contract (two roundings), or with fma=True the update that
    XLA:CPU makes of it, fma(1 - a, B, a * F). float64 holds c1 * B and
    its sum with the float32 a * F exactly here, so the one rounding to
    float32 is the FMA's."""
    a = np.float32(alpha)
    c1 = np.float32(1) - a
    bg = bg0.astype(np.float32)
    out = []
    for f in filtered:
        if fma:
            bg = (np.float64(c1) * bg + (a * f).astype(np.float64)).astype(np.float32)
        else:
            bg = c1 * bg + a * f
        out.append(np.clip(np.rint(np.abs(f - bg)), 0, 255))
    return np.stack(out)


@pytest.mark.parametrize("seed_bg", [False, True], ids=["bg0", "seed_bg"])
@pytest.mark.parametrize("name", sorted(DIFF_CONFIGS))
def test_fused_segment_diff_matches_tpuva(name, seed_bg):
    """emit="diff" against tpuva's Pallas kernel (interpret mode). The
    port's magnitudes equal the pinned two-rounding contract exactly;
    tpuva's equal the FMA form of the same recurrence exactly (ROADMAP
    Queue 3). So where the two differ (a few pixels of the seeded cases,
    whose magnitudes sit within ulps of a .5 tie), the cause is that
    fault; everywhere else they are equal."""
    kw = DIFF_CONFIGS[name]
    frames, bg0 = scene(5, 64, 96, seed=21)
    filtered = _jax_filtered(frames, kw)
    start = filtered[0] if seed_bg else bg0
    d_ref, bg_ref = jax_fused(jnp.asarray(frames), jnp.asarray(start), threshold=0.0,
                              emit="diff", **kw)
    du8, bg = fused_segment(torch.from_numpy(frames), torch.from_numpy(bg0), threshold=0.0,
                            seed_bg=seed_bg, emit="diff", **kw)
    assert du8.dtype == torch.uint8 and du8.shape == frames.shape
    contract = _rounded_diff(filtered, start, kw["alpha"], fma=False)
    np.testing.assert_array_equal(du8.numpy(), contract)
    np.testing.assert_array_equal(np.asarray(d_ref),
                                  _rounded_diff(filtered, start, kw["alpha"], fma=True))
    off = du8.numpy() != np.asarray(d_ref)
    assert off.sum() <= 3 and (off.sum() == 0 or seed_bg)
    np.testing.assert_array_equal(bg.numpy(), contract_bg(filtered, start, kw["alpha"]))
    np.testing.assert_allclose(bg.numpy(), np.asarray(bg_ref), rtol=1e-5)
    assert du8.numpy().max() > 100


@pytest.mark.parametrize("blur", [0, 5])
def test_fused_segment_diff_rounds_half_to_even(blur):
    """alpha 0 keeps the background at bg0 = k + 0.5, so every magnitude is
    an exact .5 tie: rint rounds it to even, as tpuva does (FMA and two
    roundings agree when alpha is 0)."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (3, 24, 40), dtype=np.uint8)
    bg0 = (rng.integers(0, 255, (24, 40)) + 0.5).astype(np.float32)
    kw = dict(alpha=0.0, threshold=0.0, blur_ksize=blur, emit="diff")
    d_ref, bg_ref = jax_fused(jnp.asarray(frames), jnp.asarray(bg0), **kw)
    du8, bg = fused_segment_plain(torch.from_numpy(frames), torch.from_numpy(bg0), **kw)
    np.testing.assert_array_equal(du8.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(bg.numpy(), bg0)
    np.testing.assert_array_equal(np.asarray(bg_ref), bg0)
    f = tf.gaussian_blur_u8(torch.from_numpy(frames), blur).numpy() if blur else frames
    half_up = np.floor(np.abs(f - bg0) + 0.5)
    assert (du8.numpy() != half_up).mean() > 0.3  # ties decide about half the pixels


def test_fused_segment_diff_rejects_morphology():
    frames = torch.zeros((2, 8, 8), dtype=torch.uint8)
    for kw in (dict(open_ksize=3), dict(close_ksize=3)):
        with pytest.raises(ValueError, match="morphology"):
            fused_segment(frames, torch.zeros(8, 8), alpha=0.1, threshold=0.0, emit="diff", **kw)
    with pytest.raises(ValueError, match="emit"):
        fused_segment(frames, torch.zeros(8, 8), alpha=0.1, threshold=0.0, emit="masks")


@pytest.fixture(scope="module")
def otsu_clip():
    clip, _truth, plate = moving_disk_clip(h=96, w=144, frames=24, radius=9,
                                           noise_sigma=2.0, seed=12)
    return clip, plate


@pytest.mark.parametrize("route", ["seq_bg", "parallel_bg", "staged"])
def test_otsu_batches_match_tpuva(otsu_clip, route):
    """Batch by batch from the same carry: process_batch (K1's plain
    diff emit, or the scanned background) and process_batch_staged against
    tpuva's, as tests/test_pallas_fused.py runs them: masks and rows equal."""
    clip, plate = otsu_clip
    carry_j = jp.init_carry(OTSU_CFG, 96, 144, plate)
    carry = tp.init_carry(OTSU_CFG, 96, 144, plate, **CPU)
    parallel_bg = route == "parallel_bg"
    for start in range(0, 16, 8):
        b = clip[start:start + 8]
        if route == "staged":
            carry_j, out_j = jp.process_batch_staged(OTSU_CFG, carry_j, jnp.asarray(b),
                                                     return_masks=True)
            carry, out = tp.process_batch_staged(OTSU_CFG, carry, torch.from_numpy(b),
                                                 return_masks=True)
        else:
            carry_j, out_j = jp.process_batch(OTSU_CFG, carry_j, jnp.asarray(b),
                                              parallel_bg=parallel_bg, return_masks=True)
            carry, out = tp.process_batch(OTSU_CFG, carry, torch.from_numpy(b),
                                          parallel_bg=parallel_bg, return_masks=True)
        np.testing.assert_array_equal(out["masks"].numpy(), np.asarray(out_j["masks"]))
        for k in ("rows", "row_valid", "row_sums", "n_det", "active_tracks"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(out_j[k]), err_msg=k)
        np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)
        assert out["ccl_converged"] is True and not out["stats_overflow"].any()
    assert int(out["n_det"].sum()) > 0


def test_otsu_process_clip_matches_tpuva(otsu_clip):
    clip, plate = otsu_clip
    rows_j, carry_j, masks_j = jp.process_clip(clip, OTSU_CFG, background0=plate,
                                               return_masks=True)
    rows, carry, masks = tp.process_clip(clip, OTSU_CFG, background0=plate,
                                         return_masks=True, **CPU)
    np.testing.assert_array_equal(masks, masks_j)
    assert rows == rows_j and len(rows) > 20
    assert format_rows(rows) == jax_format_rows(rows_j)
    np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)


@pytest.mark.parametrize("staged", [False, True], ids=["default", "staged"])
def test_otsu_streaming_resume_matches_tpuva(tmp_path, otsu_clip, staged):
    """tests/test_streaming.py's Otsu stop-and-resume, against tpuva's
    rows: the per-frame threshold is recomputed from the data, so it
    survives a checkpoint boundary."""
    clip, plate = otsu_clip
    ref = js.StreamingPipeline(OTSU_CFG).run(jio_memory.VideoMemory(clip), background0=plate)
    kw = dict(use_pallas=staged, force_staged=staged, **CPU)
    full = StreamingPipeline(OTSU_CFG, **kw).run(VideoMemory(clip), background0=plate)
    assert full == ref and len(full) > 20
    ckpt = str(tmp_path / "otsu_state.npz")
    StreamingPipeline(OTSU_CFG, checkpoint_path=ckpt, checkpoint_every=10**9, **kw).run(
        VideoMemory(clip[:16]), background0=plate)
    rows = StreamingPipeline(OTSU_CFG, checkpoint_path=ckpt, checkpoint_every=10**9, **kw).run(
        VideoMemory(clip), background0=plate, resume=True)
    assert rows == ref
