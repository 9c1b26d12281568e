"""Kernel K7's plain version and the routes that now run on K1b, K7 and K1m,
against tpuva on the CPU.

- ``median_u8_plain`` (K7's plain version, ops/median.py) equals tpuva's
  ``median_blur`` for k = 3 to 25 on odd frame sizes, H or W below the
  window and a one-row frame included; the dispatch rules of
  ``median_u8`` and ``median_blur``; k = 257 and 437 against numpy.
- The median route (a median k > 3: blur_u8, median_u8, then K1 without
  its blur and median; the plain versions on the CPU) equals tpuva's
  process_batch for median 5 and median 7 with Otsu, and the torch
  composition the port ran before it (filter_batch, the sequential
  background, threshold or Otsu, _morph steps) bit for bit; with a stream
  axis it equals each stream alone.
- ``_morphology`` (open_close_u8, K1m on the card) equals the _morph
  steps it replaced on the bench SEs and the refused configs'.
- The plain versions stay plain: no ``*_plain`` function reaches a
  dispatcher that launches a kernel on the card (a CUDA kernel's plain
  version must not become that kernel when chip_smoke.py runs it there).
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuva.graph.config as jcfg
import tpuva.graph.pipeline as jp
import tpuva.ops.filters as jf
from refimpl.synthetic import multi_blob_clip
from tpuva_torch.dist.multistream import init_multistream_carry
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph import pipeline as tp
from tpuva_torch.ops import filters as tf
from tpuva_torch.ops import fused_segment as fs
from tpuva_torch.ops import median as tm
from tpuva_torch.ops import wide
from tpuva_torch.ops.background import background_update
from tpuva_torch.scenes import k1_refused_config
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_pipeline import bench_cfg

MAX_COMPONENTS = 32
# odd frame sizes: H or W below the largest window, one row, one column
MEDIAN_SHAPES = [(2, 13, 17), (1, 7, 30), (2, 30, 6), (1, 1, 9), (1, 9, 1), (2, 4, 5)]


@pytest.mark.parametrize("ksize", [3, 5, 7, 9, 15, 25])
def test_median_u8_plain_matches_tpuva(ksize):
    """K7's plain version (and median_u8 and median_blur on CPU tensors,
    which take it) equals tpuva's median_blur on random bytes, uint8 in
    and out, with K7's launch count untouched."""
    rng = np.random.default_rng(ksize)
    before = tm.median_u8.launches
    for shape in MEDIAN_SHAPES:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = np.asarray(jf.median_blur(jnp.asarray(x), ksize))
        got = tm.median_u8_plain(torch.from_numpy(x), ksize)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{shape}")
        np.testing.assert_array_equal(tm.median_u8(torch.from_numpy(x), ksize).numpy(), ref)
        np.testing.assert_array_equal(tf.median_blur(torch.from_numpy(x), ksize).numpy(), ref)
    assert tm.median_u8.launches == before


def test_median_u8_arguments():
    """median_u8 takes (N, H, W) uint8 and any odd positive k; k = 1 is
    the identity."""
    x = torch.zeros((2, 5, 5), dtype=torch.uint8)
    for bad in (0, 2, -3, 256):
        with pytest.raises(ValueError):
            tm.median_u8(x, bad)
    for bad_x in (x.to(torch.float32), x[0]):
        with pytest.raises(ValueError):
            tm.median_u8(bad_x, 3)
    assert torch.equal(tm.median_u8(x + 7, 1), x + 7)


def median_reference(x, ksize):
    """The k x k median of x (N, H, W) with BORDER_REPLICATE, by numpy: the
    middle of each edge-padded window, partitioned."""
    r = ksize // 2
    xp = np.pad(x, ((0, 0), (r, r), (r, r)), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(xp, (ksize, ksize), axis=(1, 2))
    win = win.reshape(win.shape[:3] + (-1,))
    return np.partition(win, ksize * ksize // 2, axis=-1)[..., ksize * ksize // 2]


@pytest.mark.parametrize("ksize", [257, 437])
def test_median_large_ksize(ksize):
    """A window past k = 255 (257 still fits K7's shared-memory halo, 437
    does not) on the CPU: median_u8, median_blur and filter_batch's
    MedianConfig take it, as tpuva's median_blur does, and equal the numpy
    median of the edge-padded windows."""
    rng = np.random.default_rng(ksize)
    x = rng.integers(0, 256, (2, 4, 24), dtype=np.uint8)
    x[:, :2] //= 8  # a dark half: many equal values in a window
    ref = median_reference(x, ksize)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tm.median_u8(t, ksize).numpy(), ref)
    np.testing.assert_array_equal(tf.median_blur(t, ksize).numpy(), ref)
    cfg = tcfg.PipelineConfig(median=tcfg.MedianConfig(ksize))
    np.testing.assert_array_equal(tp.filter_batch(cfg, t).numpy(), ref.astype(np.float32))
    assert ref.tolist() != x.tolist()


def small_clip():
    return multi_blob_clip(64, 96, 8, n_blobs=2, radius=12.0, noise_sigma=2.0, seed=3)


def median_cfg(name, module, batch=8):
    cfg = k1_refused_config(bench_cfg(module, batch=batch), name, module)
    # a smaller min_area for the smaller clip's blobs
    return dataclasses.replace(cfg, segment=dataclasses.replace(cfg.segment, min_area=20))


def torch_composition(cfg, frames, bg0):
    """The front end the port ran for a median k > 3 before K7, from the
    plain ops: filter_batch's torch blur and median, the sequential
    background from the filtered first frame (or bg0), |F - B|, the
    threshold or the Otsu rule, the open and close as _morph steps.
    Returns (mask, post-batch background)."""
    f = tf.gaussian_blur_u8(frames, cfg.blur.ksize, cfg.blur.sigma)
    f = tf.median_u8_plain(f.to(torch.uint8), cfg.median.ksize).to(torch.float32)
    b = f[0] if bg0 is None else bg0
    diffs = []
    for t in range(f.shape[0]):
        b = background_update(b, f[t], cfg.background.alpha)
        diffs.append((f[t] - b).abs())
    d = torch.stack(diffs)
    if cfg.segment.threshold == "otsu":
        du8 = torch.clamp(torch.round(d), 0, 255).to(torch.uint8)
        thr = tf.otsu_threshold(du8).to(torch.int32)
        mask = torch.where(du8.to(torch.int32) > thr[:, None, None], 255, 0).to(torch.uint8)
    else:
        mask = tf.threshold(d, cfg.segment.threshold)
    return tf.morph_steps_plain(mask, wide.open_close_steps(tp._morph_stages(cfg))), b


@pytest.mark.parametrize("name", ["median5", "median7_otsu", "median15"])
def test_median_route_matches_tpuva(name):
    """process_batch with a median k > 3 on the CPU (blur_u8, median_u8,
    fused_segment: their plain versions) against tpuva's process_batch on
    two batches, the first without a plate: masks and rows equal, the
    background to rtol 1e-5 (R1: tpuva's XLA:CPU contracts the update into
    an FMA); the masks and background equal the old torch composition
    bit for bit."""
    frames, _alive, _truth, _plate = small_clip()
    N, H, W = 4, *frames.shape[1:]
    jc, tc = median_cfg(name, jcfg, N), median_cfg(name, tcfg, N)
    jcarry = jp.init_carry(jc, H, W)
    carry = tp.init_carry(tc, H, W, device="cpu")
    calls = []
    orig = tp.fused_segment

    def k1(*args, **kw):
        calls.append((kw["blur_ksize"], kw["median_ksize"]))
        return orig(*args, **kw)

    tp.fused_segment = k1
    try:
        n_rows = 0
        for start in range(0, frames.shape[0], N):
            batch = frames[start:start + N]
            jcarry, jout = jp.process_batch(jc, jcarry, jnp.asarray(batch), return_masks=True,
                                            max_components=MAX_COMPONENTS)
            bg0 = None if start == 0 else carry.bg
            old_mask, old_bg = torch_composition(tc, torch.from_numpy(batch), bg0)
            carry, out = tp.process_batch(tc, carry, torch.from_numpy(batch), return_masks=True,
                                          max_components=MAX_COMPONENTS)
            np.testing.assert_array_equal(out["masks"].numpy(), np.asarray(jout["masks"]))
            for k in ("rows", "row_valid", "row_sums", "n_det"):
                np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
            np.testing.assert_allclose(carry.bg.numpy(), np.asarray(jcarry.bg), rtol=1e-5)
            assert torch.equal(out["masks"], old_mask)
            assert torch.equal(carry.bg, old_bg)
            n_rows += int(out["row_valid"].sum())
    finally:
        tp.fused_segment = orig
    assert n_rows > 4
    assert calls == [(0, 0)] * 2  # K1 once a batch, with no blur and no median


def test_median_route_streams_equal_each_stream():
    """The median route with a stream axis (the S·N frames through one
    blur_u8 and one median_u8 call, K1 once for all streams) equals each
    stream through process_batch alone."""
    frames, _alive, _truth, plate = small_clip()
    cfg = median_cfg("median5", tcfg, 4)
    H, W = frames.shape[1:]
    streams = [frames[:4], frames[4:8][::-1].copy()]
    plates = np.stack([plate, frames[4]]).astype(np.float32)
    carry = init_multistream_carry(cfg, H, W, 2, plates, device="cpu")
    blur, median = wide.blur_u8, tm.median_u8
    seen = []
    tp.blur_u8 = lambda x, *a: seen.append(("blur", x.shape[0])) or blur(x, *a)
    tp.median_u8 = lambda x, *a: seen.append(("median", x.shape[0])) or median(x, *a)
    try:
        new, out = tp.process_batch(cfg, carry, torch.from_numpy(np.stack(streams)),
                                    return_masks=True, max_components=MAX_COMPONENTS)
    finally:
        tp.blur_u8, tp.median_u8 = blur, median
    assert seen == [("blur", 8), ("median", 8)]
    for s in range(2):
        one = tp.init_carry(cfg, H, W, plates[s], device="cpu")
        one_new, one_out = tp.process_batch(cfg, one, torch.from_numpy(streams[s]),
                                            return_masks=True, max_components=MAX_COMPONENTS)
        assert torch.equal(new.bg[s], one_new.bg)
        for k in ("masks", "rows", "row_valid", "row_sums"):
            assert torch.equal(out[k][s], one_out[k]), k


@pytest.mark.parametrize("name", ["bench", "open_close_7x10", "median3_5x10", "se33"])
def test_morphology_equals_morph_steps(name):
    """_morphology (open_close_u8: morph_plan's groups, K1m on the card)
    equals the _morph steps of the open then the close that it replaced,
    on random and blob masks, for the bench SEs and the refused configs'."""
    cfg = bench_cfg(tcfg) if name == "bench" else k1_refused_config(bench_cfg(tcfg), name)
    rng = np.random.default_rng(11)
    masks = [((rng.random((2, 37, 53)) < p) * 255).astype(np.uint8) for p in (0.2, 0.6)]
    blobs = multi_blob_clip(80, 120, 6, n_blobs=3, radius=14.0, births_deaths=False, seed=4)[0]
    masks.append((blobs[:2] > 100).astype(np.uint8) * 255)
    for m in masks:
        x = torch.from_numpy(m)
        ref = x
        for mc, first_erode in ((cfg.morph_open, True), (cfg.morph_close, False)):
            if mc is None:
                continue
            se = tf.structuring_element(mc.shape, mc.ksize)
            for erode in (first_erode, not first_erode):
                for _ in range(mc.iterations):
                    ref = tf._morph(ref, se, is_erode=erode)
        assert torch.equal(tp._morphology(cfg, x), ref)


# the functions that launch a kernel on a CUDA tensor (or route to one)
DISPATCHERS = [tf.median_blur, tf.erode, tf.dilate, tf.morph_open, tf.morph_close,
               tf._morph_run, tf.histogram_u8, tm.median_u8, tm.median_hist_u8, wide.blur_u8,
               wide.morph_steps,
               wide.morph_u8, wide.open_close_u8, fs.fused_segment, fs.run_split,
               fs.run_streams]


def codes_called(fn):
    """The code objects of every Python function fn() calls."""
    seen = set()

    def prof(frame, event, _arg):
        if event == "call":
            seen.add(frame.f_code)

    sys.setprofile(prof)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return seen


def plain_calls():
    """Each front-end *_plain function on small CPU inputs, by name."""
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 256, (3, 21, 33), dtype=np.uint8))
    bg0 = torch.from_numpy(rng.uniform(0, 255, (21, 33)).astype(np.float32))
    kw = dict(alpha=0.05, threshold=20.0, blur_ksize=5, open_ksize=3, close_shape="ellipse",
              close_ksize=5, close_iters=2)
    mask = (frames > 128).to(torch.uint8) * 255
    se = tf.structuring_element("ellipse", 5)
    return {
        "fused_segment_plain": lambda: fs.fused_segment_plain(frames, bg0, **kw),
        "fused_segment_plain median 3": lambda: fs.fused_segment_plain(
            frames, bg0, **dict(kw, median_ksize=3)),
        "fused_segment_plain padded_occ": lambda: fs.fused_segment_plain(
            frames, bg0, padded_occ=True, **kw),
        "fused_segment_plain diff": lambda: fs.fused_segment_plain(
            frames, bg0, alpha=0.05, threshold=0.0, blur_ksize=3, median_ksize=3, emit="diff"),
        "fused_segment_plain streams": lambda: fs.fused_segment_plain(
            torch.stack([frames, frames]), torch.stack([bg0, bg0]), **kw),
        "median_u8_plain 3": lambda: tm.median_u8_plain(frames, 3),
        "median_u8_plain 5": lambda: tm.median_u8_plain(frames, 5),
        "median_u8_counts_plain 11": lambda: tm.median_u8_counts_plain(frames, 11),
        "morph_steps_plain": lambda: tf.morph_steps_plain(mask, [(se, True), (se, False)]),
        "histogram_u8_plain": lambda: tf.histogram_u8_plain(frames),
        "pad_occ_plain": lambda: wide.pad_occ_plain(mask, (22, 128)),
    }


def test_plain_versions_reach_no_dispatcher():
    """No plain version calls a dispatcher: fused_segment_plain (every
    emit, the median 3, padded_occ, a stream axis), median_u8_plain,
    morph_steps_plain and the other front-end plain versions run only
    plain ops, so on the card they stay the kernels' yardsticks. The
    profiler does see a dispatcher where one is called."""
    dispatchers = {f.__code__: f.__qualname__ for f in DISPATCHERS}
    for name, fn in plain_calls().items():
        hit = sorted(dispatchers[c] for c in codes_called(fn) if c in dispatchers)
        assert not hit, f"{name} reached {hit}"
    x = torch.zeros((1, 5, 5), dtype=torch.uint8)
    assert tf.median_blur.__code__ in codes_called(lambda: tf.median_blur(x, 5))
