"""Kernel KS's plain version (tpuva_torch/ops/background.py) and kernel
KG's tiles (ops/filters.py) against tpuva and numpy on the CPU.

The scanned background (parallel_bg) is tpuva's jax.lax.associative_scan
of the affine maps B -> s B + o. Its specification here is a numpy float32
replay of that combination tree, every op rounded on its own
(np_associative_scan): the port's plain scan equals it bit for bit at every
N from 1 to 300, and so do KS's in-place loops (scan_tables' s values,
scan_model's o values, the loops csrc/background.cu runs). tpuva's
background_trajectory(parallel=True) on the JAX CPU backend is held within
rtol 1e-6: XLA:CPU may contract its s2 * o1 + o2 into an FMA. The
background_scan emits, seeded and carried, give tpuva's process_batch
masks and rows (fixed threshold and Otsu); process_clip and
StreamingPipeline with parallel_bg=True give tpuva's rows at 96 x 256.
FilterBackground on float frames (KS's sequential order) equals a numpy
replay of its two-rounding loop bit for bit and tpuva within R1's one
rounding step. KG's launch plan and a numpy model of its staged tiles equal
gaussian_blur_plain. The plain versions call no function that launches a
kernel on a CUDA tensor, and CPU calls launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuva.filters as jf
import tpuva.graph.config as jcfg
import tpuva.graph.pipeline as jp
from refimpl.synthetic import multi_blob_clip
from tpuva.graph.streaming import StreamingPipeline as JStreamingPipeline
from tpuva.io.memory import VideoMemory as JVideoMemory
from tpuva_torch import filters as tf
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph import pipeline as tp
from tpuva_torch.graph.streaming import StreamingPipeline
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.ops import background as bgo
from tpuva_torch.ops import filters as fo
from test_torch_kernels import one_torch_thread  # noqa: F401

f32 = np.float32
MAX_COMPONENTS = 32


def np_associative_scan(s, o):
    """jax.lax.associative_scan of combine((s1, o1), (s2, o2)) = (s1 s2,
    s2 o1 + o2) along axis 0 in numpy float32, each op rounded on its own:
    pairs, the recursion on their results, then each odd result combined
    with the next even element."""
    n = s.shape[0]
    if n < 2:
        return s, o

    def combine(s1, o1, s2, o2):
        return (s1 * s2).astype(f32), ((s2 * o1).astype(f32) + o2).astype(f32)

    odd_s, odd_o = np_associative_scan(*combine(s[0:-1:2], o[0:-1:2], s[1::2], o[1::2]))
    k = len(odd_s) if n % 2 else len(odd_s) - 1
    ev_s, ev_o = combine(odd_s[:k], odd_o[:k], s[2::2], o[2::2])
    S, O = np.empty_like(s), np.empty_like(o)
    S[0::2], S[1::2] = np.concatenate([s[:1], ev_s]), odd_s
    O[0::2], O[1::2] = np.concatenate([o[:1], ev_o]), odd_o
    return S, O


def np_trajectory(bg0, frames, alpha):
    a = f32(alpha)
    s = np.full((len(frames),) + (1,) * (frames.ndim - 1), f32(1) - a, f32)
    S, O = np_associative_scan(s, (a * frames.astype(f32)).astype(f32))
    return ((S * bg0[None]).astype(f32) + O).astype(f32)


# --------------------------------------------------------- the scan's tree
@pytest.mark.parametrize("lo", range(1, 301, 50))
def test_plain_scan_equals_the_numpy_tree(lo):
    """The port's plain scan (_affine_scan through scan_trajectory, and
    background_scan_plain's emits) equals the numpy replay of jax's tree
    for every N in [lo, lo + 50), odd and even."""
    rng = np.random.default_rng(lo)
    for N in range(lo, lo + 50):
        frames = rng.integers(0, 256, (N, 2, 3)).astype(f32)
        frames[:, 0, 0] += rng.random(N, dtype=f32)  # a float column too
        bg0 = rng.uniform(0, 255, (2, 3)).astype(f32)
        ref = np_trajectory(bg0, frames, 0.02)
        got = bgo.scan_trajectory(torch.from_numpy(bg0), torch.from_numpy(frames), 0.02)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"N = {N}")
        out, last = bgo.background_scan_plain(torch.from_numpy(frames), torch.from_numpy(bg0),
                                              0.02, False, "scan", "diff")
        np.testing.assert_array_equal(out.numpy(), np.clip(np.rint(np.abs(frames - ref)), 0, 255))
        np.testing.assert_array_equal(last.numpy(), ref[-1])


@pytest.mark.parametrize("lo", range(1, 301, 50))
def test_kernel_loops_equal_the_numpy_tree(lo):
    """KS's in-place loops: scan_tables' last N values equal the tree's S,
    and scan_model (the o values through the loops with the table's s2)
    its O, bit for bit, for every N in [lo, lo + 50) and two alphas; the
    table holds one s2 a combine of the loops."""
    rng = np.random.default_rng(lo + 7)
    for alpha in (0.02, 0.3):
        a = f32(alpha)
        for N in range(lo, lo + 50):
            o = (a * rng.integers(0, 256, (N, 3)).astype(f32)).astype(f32)
            S, O = np_associative_scan(np.full((N, 1), f32(1) - a, f32), o)
            tables = bgo.scan_tables(N, alpha)
            ops = tables.size - N
            assert ops == sum(1 for _ in bgo._scan_ops(N))
            np.testing.assert_array_equal(tables[ops:], S[:, 0], err_msg=f"S, N = {N}")
            np.testing.assert_array_equal(bgo.scan_model(o, tables), O, err_msg=f"O, N = {N}")


def test_scan_counts_and_plan():
    """At N = 256 the loops combine 255 times up and 247 down; scan_plan
    keeps 224 pixels a CTA in shared memory at N = 256, 32 at 1024, and
    past 1816 takes the global scratch."""
    assert sum(1 for _ in bgo._scan_ops(256)) == 502
    assert sum(1 for _ in bgo._scan_ops(1)) == 0
    p = bgo.scan_plan(256, 1920 * 1080)
    assert (p.px, p.shared, p.smem) == (224, True, 4 * 256 * 224)
    assert p.grid * p.px >= 1920 * 1080 > (p.grid - 1) * p.px
    assert p.smem <= bgo.KS_SMEM_MAX
    assert bgo.scan_plan(1024, 100)[:2] == (32, True)
    assert bgo.scan_plan(1816, 100).shared and not bgo.scan_plan(1817, 100).shared
    g = bgo.scan_plan(4096, 1920 * 1080)
    assert (g.px, g.grid, g.scratch) == (256, bgo.KS_GLOBAL_CTAS, 4096 * 256 * g.grid)
    for N in (1, 2, 3, 255, 257, 700):
        p = bgo.scan_plan(N, 5)
        assert p.px % 32 == 0 and p.smem == 4 * N * p.px <= bgo.KS_SMEM_MAX


@pytest.mark.parametrize("N", [1, 2, 7, 16, 33, 100])
def test_scan_trajectory_matches_tpuva(N):
    """tpuva's background_trajectory(parallel=True) on the JAX CPU backend
    within rtol 1e-6 (XLA may contract s2 * o1 + o2)."""
    rng = np.random.default_rng(N)
    frames = rng.integers(0, 256, (N, 5, 7)).astype(f32)
    bg0 = rng.uniform(0, 255, (5, 7)).astype(f32)
    ref = np.asarray(jp.background_trajectory(jnp.asarray(bg0), jnp.asarray(frames), 0.02,
                                              parallel=True))
    got = tp.background_trajectory(torch.from_numpy(bg0), torch.from_numpy(frames), 0.02,
                                   parallel=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(got, np_trajectory(bg0, frames, 0.02))


# ------------------------------------------------------------- the route
def bench_cfg(module, threshold=35.0, batch=16):
    return module.PipelineConfig(
        background=module.BackgroundConfig(alpha=0.02),
        blur=module.BlurConfig(ksize=5, sigma=0.0),
        morph_open=module.MorphConfig(ksize=3, shape="rect"),
        morph_close=module.MorphConfig(ksize=3, shape="ellipse"),
        segment=module.SegmentConfig(threshold=threshold, min_area=50, max_blobs=8),
        track=module.TrackConfig(max_dist=80.0, death_patience=5, max_tracks=16,
                                 assigner="hungarian"),
        batch=batch,
    )


@pytest.fixture(scope="module")
def clip():
    return multi_blob_clip(96, 256, 48, n_blobs=4, radius=8.0, births_deaths=True,
                           noise_sigma=2.0, seed=26)


@pytest.mark.parametrize("threshold", [35.0, "otsu"], ids=["fixed", "otsu"])
def test_scan_emits_seeded_and_carried_match_tpuva(clip, threshold):
    """process_batch(parallel_bg=True), its front end background_scan's
    plain version on the CPU (the mask emit, or the diff emit for Otsu),
    from a carry with no background (seeded from the first filtered frame)
    and then carried over two more batches: masks and rows equal tpuva's,
    the background within rtol 1e-6; the emit alone equals
    background_scan_plain on the filtered frames."""
    frames = clip[0]
    carry_j = jp.init_carry(bench_cfg(jcfg, threshold), 96, 256)
    carry = tp.init_carry(bench_cfg(tcfg, threshold), 96, 256, device="cpu")
    cfg = bench_cfg(tcfg, threshold)
    for start in range(0, 48, 16):
        chunk = frames[start:start + 16]
        bg_in, seed = carry.bg.clone(), not bool(carry.bg_valid)
        carry_j, out_j = jp.process_batch(bench_cfg(jcfg, threshold), carry_j,
                                          jnp.asarray(chunk), parallel_bg=True,
                                          return_masks=True, max_components=MAX_COMPONENTS)
        carry, out = tp.process_batch(cfg, carry, torch.from_numpy(chunk), parallel_bg=True,
                                      return_masks=True, max_components=MAX_COMPONENTS)
        np.testing.assert_array_equal(out["masks"].numpy(), np.asarray(out_j["masks"]))
        for k in ("rows", "row_valid", "row_sums", "n_det"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(out_j[k]), err_msg=k)
        np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=1e-6)
        f = tp._filter_u8(cfg, torch.from_numpy(chunk))
        otsu = threshold == "otsu"
        emit, bg_last = bgo.background_scan_plain(f, bg_in, 0.02, seed, "scan",
                                                  "diff" if otsu else "mask",
                                                  None if otsu else threshold)
        want = tp._otsu_mask(cfg, emit) if otsu else tp._morphology(cfg, emit)
        np.testing.assert_array_equal(want.numpy(), out["masks"].numpy())
        np.testing.assert_array_equal(bg_last.numpy(), carry.bg.numpy())
    assert int(out["n_det"].sum()) > 0


@pytest.fixture(scope="module")
def jax_scanned(clip):
    frames, _alive, _truth, plate = clip
    return jp.process_clip(frames, bench_cfg(jcfg), background0=plate, parallel_bg=True,
                           max_components=MAX_COMPONENTS)[0]


@pytest.mark.parametrize("route", ["process_clip", "StreamingPipeline"])
def test_scanned_routes_match_tpuva(clip, jax_scanned, route):
    """process_clip(parallel_bg=True) and StreamingPipeline(parallel_bg=
    True) at 96 x 256 give tpuva's process_clip rows, row for row; so does
    tpuva's own StreamingPipeline."""
    frames, _alive, _truth, plate = clip
    if route == "process_clip":
        rows = tp.process_clip(frames, bench_cfg(tcfg), background0=plate, parallel_bg=True,
                               max_components=MAX_COMPONENTS, device="cpu")[0]
    else:
        rows = StreamingPipeline(bench_cfg(tcfg), max_components=MAX_COMPONENTS,
                                 parallel_bg=True, device="cpu").run(VideoMemory(frames),
                                                                     background0=plate)
        rows_j = JStreamingPipeline(bench_cfg(jcfg), max_components=MAX_COMPONENTS,
                                    parallel_bg=True).run(JVideoMemory(frames),
                                                          background0=plate)
        assert [tuple(r) for r in rows_j] == [tuple(r) for r in jax_scanned]
    assert len(rows) > 60
    assert [tuple(r) for r in rows] == [tuple(r) for r in jax_scanned]


# --------------------------------------------------- the float background
def np_background_loop(frames, alpha, bg0=None, thr=None):
    """FilterBackground's loop in numpy float32: b = c1 b + a f (two
    products, one sum, each rounded), then clip(rint(|f - b|)), or with
    thr the mask |f - b| > float32(thr); seeded from the first frame where
    bg0 is None. Returns (out, b)."""
    a = f32(alpha)
    c1 = f32(1) - a
    b = frames[0] if bg0 is None else bg0
    out = np.empty(frames.shape, np.uint8)
    for t, f in enumerate(frames):
        b = ((c1 * b).astype(f32) + (a * f).astype(f32)).astype(f32)
        d = np.abs(f - b)
        out[t] = np.clip(np.rint(d), 0, 255) if thr is None else np.where(d > f32(thr), 255, 0)
    return out, b


def float_source(module, v, **d):
    """Non-integer float frames in [0.25, 200.75]: FilterNormalize, then a
    scale and an offset."""
    return module.FilterFunction(module.FilterNormalize(v, **d), lambda f: f * 200.5 + 0.25)


def test_float_background_equals_numpy_loop_and_tpuva():
    """FilterBackground on float frames (KS's sequential order; its plain
    version here) over three batches equals one pass, the numpy loop bit
    for bit, and tpuva's within R1's one rounding step (uint8 at most 1
    apart on at most U8_SHARE of the pixels)."""
    from test_torch_filter_chain import assert_u8_close, batches, valid

    data = np.random.default_rng(26).integers(0, 256, (12, 37, 53), dtype=np.uint8)
    inner = valid(batches(float_source(tf, VideoMemory(data), device="cpu"), 12))
    assert inner.dtype == np.float32 and (inner != np.rint(inner)).mean() > 0.9

    def make(M, v, **d):
        return M.FilterBackground(float_source(M, v, **d), 0.05)

    got = batches(make(tf, VideoMemory(data), device="cpu"), 4)
    assert len(got) == 3
    one = batches(make(tf, VideoMemory(data), device="cpu"), 12)
    np.testing.assert_array_equal(valid(got), valid(one))
    np.testing.assert_array_equal(valid(got), np_background_loop(inner, 0.05)[0])
    ref = batches(make(jf, JVideoMemory(data)), 4)
    assert_u8_close(valid(got), valid(ref), "float background over three batches")


@pytest.mark.parametrize("emit", ["diff", "mask"])
def test_sequential_plain_equals_numpy_loop(emit):
    """background_scan_plain(order="sequential") from a background and
    seeded by a flag tensor: the numpy loop, bit for bit, both emits."""
    rng = np.random.default_rng(3)
    frames = (rng.random((9, 6, 11), dtype=f32) * 255).astype(f32)
    bg0 = rng.uniform(0, 255, (6, 11)).astype(f32)
    for seed_bg in (False, torch.tensor(True)):
        out, b = bgo.background_scan_plain(torch.from_numpy(frames), torch.from_numpy(bg0), 0.3,
                                           seed_bg, "sequential", emit, 40.0)
        ref, rb = np_background_loop(frames, 0.3, None if seed_bg is not False else bg0,
                                     40.0 if emit == "mask" else None)
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(b.numpy(), rb)


def test_background_scan_argument_errors():
    x = torch.zeros((2, 3, 4), dtype=torch.uint8)
    bg = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="order"):
        bgo.background_scan(x, bg, 0.02, order="parallel")
    with pytest.raises(ValueError, match="threshold"):
        bgo.background_scan(x, bg, 0.02, emit="mask")
    with pytest.raises(ValueError, match="N >= 1"):
        bgo.background_scan(x[:0], bg, 0.02, emit="diff")


# ---------------------------------------------------------------- KG tiles
def kg_model(x, ksize, sigma, C):
    """A numpy model of KG's staged route, tile by tile as
    blur_float_plan sizes it: x (L, H, W, C) float32. Each tile stages
    its rows and columns with the REFLECT_101 halo, the row pass of every
    staged row, then the column pass, in gaussian_blur_plain's order."""
    L, H, W, _ = x.shape
    r = ksize // 2
    th, tw, smem = fo.blur_float_plan(C, ksize)
    assert smem > 0
    binom = fo.is_binomial_blur(ksize, sigma)
    k = fo.gaussian_kernel_1d(ksize, sigma)

    def taps(v):  # v (..., 2r + 1) along the last axis
        if binom:
            y = [v[..., j] for j in range(2 * r + 1)]
            for lvl in range(2 * r):
                y = [(y[j] + y[j + 1]).astype(f32) for j in range(2 * r - lvl)]
            return y[0]
        acc = (v[..., r] * k[r]).astype(f32)
        for i in range(1, r + 1):
            acc = (acc + (k[r - i] * (v[..., r - i] + v[..., r + i]).astype(f32))).astype(f32)
        return acc

    out = np.empty_like(x)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            rows = fo.reflect101_index(H, y0 - r, y0 + th + r)
            cols = fo.reflect101_index(W, x0 - r, x0 + tw + r)
            stage = x[:, rows][:, :, cols]  # (L, th + 2r, tw + 2r, C)
            win = np.stack([stage[:, :, j:j + tw] for j in range(2 * r + 1)], axis=-1)
            R = taps(win)  # (L, th + 2r, tw, C)
            win = np.stack([R[:, j:j + th] for j in range(2 * r + 1)], axis=-1)
            v = taps(win)
            if binom:
                v = (v * f32(2.0 ** (-2 * (ksize - 1)))).astype(f32)
            h, w = min(th, H - y0), min(tw, W - x0)
            out[:, y0:y0 + h, x0:x0 + w] = v[:, :h, :w]
    return out


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.0), (7, 0.0), (9, 1.5), (31, 0.0)])
def test_kg_tiles_equal_plain(ksize, sigma):
    """KG's tiles (kg_model at blur_float_plan's tile) equal
    gaussian_blur_plain bit for bit on non-integer frames: gray and BGR,
    tiles cut at the right and bottom edges, one column, H and W below the
    radius."""
    rng = np.random.default_rng(ksize)
    for shape in ((2, 37, 70), (1, 70, 130), (2, 5, 1), (1, 3, 9), (2, 40, 2)):
        for C in (1, 3):
            x = rng.random(shape + (C,), dtype=f32)
            ref = fo.gaussian_blur_plain(torch.from_numpy(x), ksize, sigma,
                                         channels_last=True).numpy()
            np.testing.assert_array_equal(kg_model(x, ksize, sigma, C), ref,
                                          err_msg=f"{shape} C {C}")
            if C == 1:
                plain = fo.gaussian_blur_plain(torch.from_numpy(x[..., 0]), ksize, sigma)
                np.testing.assert_array_equal(plain.numpy(), ref[..., 0])


def test_kg_plan():
    """blur_float_plan: the largest of KG_TILES within 48 KB, else within
    227 KB, else the direct route; its bytes are the taps, the staged
    inputs and the row pass."""
    def need(th, tw, C, r):
        return 4 * (r + 1 + (th + 2 * r) * (tw + 2 * r) * C + (th + 2 * r) * tw * C)

    assert fo.blur_float_plan(1, 9) == (32, 64, need(32, 64, 1, 4))
    assert fo.blur_float_plan(3, 9) == (16, 64, need(16, 64, 3, 4))
    assert fo.blur_float_plan(3, 31) == (8, 32, need(8, 32, 3, 15))
    for C in (1, 3):
        for ksize in range(3, 260, 2):
            th, tw, smem = fo.blur_float_plan(C, ksize)
            if smem:
                assert smem == need(th, tw, C, ksize // 2) <= fo.KG_SMEM_MAX
                assert (th, tw) in fo.KG_TILES
            else:
                assert need(1, 32, C, ksize // 2) > fo.KG_SMEM_MAX
    assert fo.blur_float_plan(1, 221).smem == 0 and fo.blur_float_plan(3, 121).smem == 0


# --------------------------------------------------- plain stays plain
def test_plain_versions_reach_no_dispatcher():
    """background_scan_plain (both orders) and gaussian_blur_plain call
    none of the functions that launch kernels on a CUDA tensor."""
    from test_torch_median import DISPATCHERS, codes_called

    dispatchers = {f.__code__: f.__qualname__
                   for f in DISPATCHERS + [bgo.background_scan, fo.gaussian_blur]}
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (5, 6, 7),
                                                                dtype=np.uint8))
    bg0 = torch.zeros((6, 7))
    x = torch.rand((2, 9, 8, 3))
    plain = {
        "scan": lambda: bgo.background_scan_plain(frames, bg0, 0.02, True, "scan", "mask", 9),
        "sequential": lambda: bgo.background_scan_plain(frames, bg0, 0.02, False, "sequential",
                                                        "diff"),
        "blur_cascade": lambda: fo.gaussian_blur_plain(x, 5, 0.0, channels_last=True),
        "blur_taps": lambda: fo.gaussian_blur_plain(x[..., 0], 9, 1.5),
    }
    for name, fn in plain.items():
        hit = sorted(dispatchers[c] for c in codes_called(fn) if c in dispatchers)
        assert not hit, f"{name} reached {hit}"
    assert bgo.background_scan.__code__ in codes_called(
        lambda: bgo.background_scan(frames, bg0, 0.02, emit="diff"))


def test_cpu_calls_launch_nothing(clip):
    """The scanned route, a float chain through FilterBlur and
    FilterBackground, and the ops on CPU tensors leave KS's and KG's
    counters at 0."""
    before = (bgo.background_scan.launches, bgo.background_scan.sequential_launches,
              fo.gaussian_blur.launches)
    frames, _alive, _truth, plate = clip
    tp.process_clip(frames[:16], bench_cfg(tcfg), background0=plate, parallel_bg=True,
                    device="cpu")
    data = np.random.default_rng(2).integers(0, 256, (6, 21, 34, 3), dtype=np.uint8)
    chain = tf.FilterBlur(tf.FilterNormalize(VideoMemory(data), device="cpu"), 1.5, 9)
    assert len(list(chain.iter_batches(4))) == 2
    gray = tf.FilterBackground(tf.FilterBlur(tf.FilterNormalize(
        VideoMemory(data[..., 0]), device="cpu"), 0.0, 5), 0.02)
    assert len(list(gray.iter_batches(4))) == 2
    assert (bgo.background_scan.launches, bgo.background_scan.sequential_launches,
            fo.gaussian_blur.launches) == before
