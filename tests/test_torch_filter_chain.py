"""The port's filter chain (tpuva_torch/filters.py) against tpuva's on the CPU.

Every filter on the same VideoMemory, gray and BGR at an odd 37 x 53,
through iter_batches at batch sizes that split the clip, leave a padded
tail, or exceed it. Exact filters (crop, flip, turns, the u8 blur, the
median, the time difference, the normalisation, the binomial float blur,
the float background, a function) equal tpuva's bit for bit. Where tpuva's
XLA:CPU run contracts a product and a sum into one FMA (FilterMonochrome's
BGR weights, the resize's taps, the float blur's other kernels, the warp,
the u8 background's update: ROADMAP Queue 3 R1 and R5) the port is held
bit-equal to a numpy float32 evaluation of tpuva's expression in source
order, every op rounded on its own, and to tpuva within the stated
tolerance: uint8 at most 1 apart on at most U8_SHARE of the pixels, float
within the rounding steps involved. Then get_frame, first_batch_drop,
docs/MIGRATION.md's chain, a background carried over three batches,
BatchStager staging a chain by its root (never reading the chain frame by
frame), and StreamingPipeline and MultiStreamPipeline over chains against
tpuva's.
"""

import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

import tpuva.dist as jd
import tpuva.filters as jf
import tpuva.graph.config as jcfg
import tpuva.ops.filters as jops
from refimpl.synthetic import moving_disk_clip
from tpuva.graph.streaming import StreamingPipeline as JStreamingPipeline
from tpuva.io.memory import VideoMemory as JVideoMemory
from tpuva_torch import filters as tf
from tpuva_torch.dist import MultiStreamPipeline
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph.streaming import StreamingPipeline
from tpuva_torch.io.base import VideoBase
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.io.staging import BatchStager
from tpuva_torch.ops.filters import gaussian_blur_plain, gaussian_kernel_1d
from test_torch_kernels import one_torch_thread  # noqa: F401

f32 = np.float32
CPU = "cpu"
T, H, W = 10, 37, 53
# at most 1 apart on at most this share of the pixels, where tpuva contracts
U8_SHARE = 0.0025
# batch sizes: a padded tail of 2, an exact split (one batch past the clip:
# the contracting filters' 16)
BATCHES = (4, 5)
WARP_M = np.array([[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]])


def clip(color=False, seed=0, t=T, h=H, w=W):
    shape = (t, h, w, 3) if color else (t, h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def batches(chain, batch):
    return [(n, out) for n, out in chain.iter_batches(batch, pad_last=True)]


def valid(pairs):
    """The valid rows of every batch, stacked."""
    return np.concatenate([out[:n] for n, out in pairs])


def run_both(make, data, batch):
    """make(module, video, **kw) -> chain, for tpuva and the port (on the CPU):
    their iter_batches(batch, pad_last=True) pairs."""
    got = batches(make(tf, VideoMemory(data), device=CPU), batch)
    ref = batches(make(jf, JVideoMemory(data)), batch)
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert [(o.shape, o.dtype) for _, o in got] == [(o.shape, o.dtype) for _, o in ref]
    return got, ref


# ----------------------------------------------------------- exact filters
EXACT = {
    "crop_rect": lambda M, v, **d: M.FilterCrop(v, (3, 5, 20, 17), **d),
    "crop_quadrant": lambda M, v, **d: M.FilterCrop(v, "lower right", **d),
    "flip_h": lambda M, v, **d: M.FilterFlip(v, **d),
    "flip_v": lambda M, v, **d: M.FilterFlip(v, False, **d),
    "turns_1": lambda M, v, **d: M.FilterRotate(v, turns=1, **d),
    "turns_2": lambda M, v, **d: M.FilterRotate(v, turns=2, **d),
    "turns_3": lambda M, v, **d: M.FilterRotate(v, turns=-1, **d),
    "blur_u8_3": lambda M, v, **d: M.FilterBlur(v, 0.0, 3, **d),
    "blur_u8_5": lambda M, v, **d: M.FilterBlur(v, 0.0, 5, **d),
    "blur_u8_auto": lambda M, v, **d: M.FilterBlur(v, **d),  # ksize 7 from sigma 0
    "blur_u8_9": lambda M, v, **d: M.FilterBlur(v, 0.0, 9, **d),
    "blur_u8_sigma": lambda M, v, **d: M.FilterBlur(v, 1.3, 11, **d),
    "median_3": lambda M, v, **d: M.FilterMedian(v, 3, **d),
    "median_5": lambda M, v, **d: M.FilterMedian(v, 5, **d),
    "normalize": lambda M, v, **d: M.FilterNormalize(v, 3.3, 77.7, **d),
    "normalize_default": lambda M, v, **d: M.FilterNormalize(v, **d),
    "time_difference": lambda M, v, **d: M.FilterTimeDifference(v, **d),
    # the float blur's binomial kernels are tpuva's adds, in its order
    "blur_float_3": lambda M, v, **d: M.FilterBlur(M.FilterNormalize(v, **d), 0.0, 3),
    "blur_float_5": lambda M, v, **d: M.FilterBlur(M.FilterNormalize(v, **d), 0.0, 5),
    "background_float": lambda M, v, **d: M.FilterBackground(M.FilterNormalize(v, **d), 0.05),
    "monochrome_gray": lambda M, v, **d: M.FilterMonochrome(v, **d),
    "function": lambda M, v, **d: M.FilterFunction(v, lambda f: f // 2 + 1, **d),
    "nested_normalize_time_difference": lambda M, v, **d: M.FilterNormalize(
        M.FilterTimeDifference(v, **d), -255, 255),
}


# filters that take gray frames only (the background), or pass them through
GRAY_ONLY = {"background_float", "monochrome_gray"}
EXACT_CASES = [(name, color) for name in sorted(EXACT) for color in ("gray", "bgr")
               if color == "gray" or name not in GRAY_ONLY]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name,color", EXACT_CASES)
def test_exact_filters_match_tpuva(name, color, batch):
    color = color == "bgr"
    got, ref = run_both(EXACT[name], clip(color), batch)
    for (n, a), (_n, b) in zip(got, ref):
        np.testing.assert_array_equal(a[:n], b[:n])


def test_migration_chain_matches_tpuva():
    """docs/MIGRATION.md's nested chain, FilterBlur(FilterCrop(video,
    "upper left"), 3), on both colour layouts."""
    for color in (False, True):
        got, ref = run_both(
            lambda M, v, **d: M.FilterBlur(M.FilterCrop(v, "upper left", **d), 3), clip(color), 4)
        np.testing.assert_array_equal(valid(got), valid(ref))


# ------------------------------------------- where tpuva's XLA:CPU contracts
def np_mono(x):
    w = jf._BGR_WEIGHTS
    f = x.astype(f32)
    g = (f[..., 0] * w[0] + f[..., 1] * w[1]) + f[..., 2] * w[2]
    return np.clip(np.rint(g), 0, 255).astype(np.uint8)


def jax_weights(m, n):
    return np.asarray(compute_weight_mat(m, n, n / m, 0.0, _fill_triangle_kernel, False))


def np_resize_axis(x, axis, n):
    """tpuva's einsum over one axis in source order: the sum over the input
    index in increasing order of w[i, o] * x[i], each op in float32."""
    w = jax_weights(x.shape[axis], n)
    shape = [1] * x.ndim
    shape[axis] = n
    out = np.zeros(x.shape[:axis] + (n,) + x.shape[axis + 1:], f32)
    for i in range(x.shape[axis]):
        out = out + w[i].reshape(shape) * np.take(x, [i], axis=axis)
    return out


def np_resize(x, size):
    w, h = size
    y = x.astype(f32)
    if y.shape[1] != h:
        y = np_resize_axis(y, 1, h)
    if y.shape[2] != w:
        y = np_resize_axis(y, 2, w)
    return np.clip(np.rint(y), 0, 255).astype(np.uint8)


def np_conv_axis(x, kernel, axis):
    r = len(kernel) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="reflect")
    n = x.shape[axis]

    def sl(off):
        return np.take(xp, np.arange(off, off + n), axis=axis)

    out = sl(r) * kernel[r]
    for i in range(1, r + 1):
        out = out + kernel[r - i] * (sl(r - i) + sl(r + i))
    return out


def np_cascade_axis(x, ksize, axis):
    """tpuva's box cascade along axis: reflect-pad by r, then 2r levels of
    adjacent-pair sums, each rounded (the binomial kernels, unscaled)."""
    r = ksize // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    y = np.pad(x, pad, mode="reflect")
    for _ in range(2 * r):
        n = y.shape[axis]
        y = np.take(y, np.arange(n - 1), axis=axis) + np.take(y, np.arange(1, n), axis=axis)
    return y


def np_blur_float(x, ksize, sigma):
    y = np.moveaxis(x, -1, 1) if x.ndim == 4 else x
    if jops.is_binomial_blur(ksize, sigma):
        y = np_cascade_axis(np_cascade_axis(y, ksize, y.ndim - 1), ksize, y.ndim - 2)
        y = y * f32(2.0 ** (-2 * (ksize - 1)))
    else:
        k = jops.gaussian_kernel_1d(ksize, sigma)
        y = np_conv_axis(np_conv_axis(y, k, y.ndim - 1), k, y.ndim - 2)
    return np.moveaxis(y, 1, -1) if x.ndim == 4 else y


def np_warp(img, M, out_size=None, inverse=False, border="constant", border_value=0.0):
    """tpuva's warp_affine in float32 numpy, every op rounded on its own."""
    from tpuva.ops.warp import invert_affine

    chan = img.shape[-1] == 3 and img.ndim >= 3
    sp = img.ndim - (3 if chan else 2)
    Hs, Ws = img.shape[sp], img.shape[sp + 1]
    w_out, h_out = out_size if out_size is not None else (Ws, Hs)
    Mi = np.asarray(M, np.float64).reshape(2, 3)
    if not inverse:
        Mi = invert_affine(Mi)
    ia, ib, ic = (f32(v) for v in Mi[0])
    id_, ie, if_ = (f32(v) for v in Mi[1])
    xs = np.arange(w_out, dtype=f32)[None, :]
    ys = np.arange(h_out, dtype=f32)[:, None]
    sx = ia * xs + ib * ys + ic
    sy = id_ * xs + ie * ys + if_
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    fimg = img.astype(f32)
    if chan:
        fimg = np.moveaxis(fimg, -1, 0)
    lead = fimg.shape[:-2]
    flat = fimg.reshape(lead + (Hs * Ws,))

    def corner(xi, yi):
        idx = (np.clip(yi, 0, Hs - 1) * Ws + np.clip(xi, 0, Ws - 1)).reshape(-1)
        g = np.take(flat, idx, axis=-1).reshape(lead + (h_out, w_out))
        if border == "constant":
            g = np.where((xi >= 0) & (xi < Ws) & (yi >= 0) & (yi < Hs), g, f32(border_value))
        return g

    g00, g01 = corner(x0, y0), corner(x0 + 1, y0)
    g10, g11 = corner(x0, y0 + 1), corner(x0 + 1, y0 + 1)
    top = g00 + fx * (g01 - g00)
    bot = g10 + fx * (g11 - g10)
    out = top + fy * (bot - top)
    if chan:
        out = np.moveaxis(out, 0, -1)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def np_background(frames, alpha):
    """tpuva's FilterBackground scan over a whole gray uint8 clip: the
    update as two products and one sum, then clip(rint(|F - B|))."""
    a = f32(alpha)
    c1 = f32(1) - a
    f = frames.astype(f32)
    b = f[0]
    out = np.empty(frames.shape, np.uint8)
    for t in range(len(f)):
        b = c1 * b + a * f[t]
        out[t] = np.clip(np.rint(np.abs(f[t] - b)), 0, 255)
    return out


def rotate_m(angle):
    from tpuva.ops.warp import rotation_matrix

    return rotation_matrix(((W - 1) / 2.0, (H - 1) / 2.0), angle)


# (make, numpy source-order reference on the whole clip, colours it takes)
CONTRACTING = {
    "monochrome": (lambda M, v, **d: M.FilterMonochrome(v, **d), np_mono, (True,)),
    "resize_down": (lambda M, v, **d: M.FilterResize(v, (26, 18), **d),
                    lambda x: np_resize(x, (26, 18)), (False, True)),
    "resize_up": (lambda M, v, **d: M.FilterResize(v, (80, 55), **d),
                  lambda x: np_resize(x, (80, 55)), (False, True)),
    "resize_h_only": (lambda M, v, **d: M.FilterResize(v, (53, 20), **d),
                      lambda x: np_resize(x, (53, 20)), (False, True)),
    "rotate_angle": (lambda M, v, **d: M.FilterRotate(v, angle=7.5, **d),
                     lambda x: np_warp(x, rotate_m(7.5)), (False, True)),
    "rotate_replicate": (lambda M, v, **d: M.FilterRotate(v, angle=-33, border="replicate", **d),
                         lambda x: np_warp(x, rotate_m(-33), border="replicate"), (False, True)),
    "warp_affine": (lambda M, v, **d: M.FilterWarpAffine(v, WARP_M, out_size=(40, 30),
                                                         border_value=17, **d),
                    lambda x: np_warp(x, WARP_M, (40, 30), border_value=17), (False, True)),
    "background_u8": (lambda M, v, **d: M.FilterBackground(v, 0.05, **d),
                      lambda x: np_background(x, 0.05), (False,)),
}


def assert_u8_close(got, ref, where):
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= U8_SHARE, (where, int(d.max()), (d > 0).mean())


@pytest.mark.parametrize("batch", (4, 16))
@pytest.mark.parametrize("name", sorted(CONTRACTING))
def test_contracting_filters_source_order_and_tolerance(name, batch):
    make, reference, colors = CONTRACTING[name]
    for color in colors:
        data = clip(color, seed=1)
        got, ref = run_both(make, data, batch)
        np.testing.assert_array_equal(valid(got), reference(data))
        assert_u8_close(valid(got), valid(ref), (name, color))


BLUR_FLOAT = [(7, 0.0), (9, 0.0), (11, 0.0), (5, 1.3), (3, 0.0), (5, 0.0)]


@pytest.mark.parametrize("ksize,sigma", BLUR_FLOAT)
def test_float_blur_source_order_and_tolerance(ksize, sigma):
    """FilterBlur on float frames: bit-equal to numpy's source order (the
    weighted taps, or for ksize 3 and 5 with sigma <= 0 tpuva's box cascade
    on the non-integer frames FilterNormalize gives); against tpuva within
    the r = ksize // 2 FMAs an axis that its XLA:CPU run contracts, each at
    most half an ulp of the largest magnitude (the frames lie in [0, 1], the
    taps sum to 1; the cascade has none). Gray and BGR, the BGR batch as
    FilterBlur hands it to gaussian_blur, (N, H, W, 3) with the channels
    interleaved; at 37 x 53 and with H equal to the radius (a radius past
    the last row: repeated reflection; one row at ksize 3)."""
    r = ksize // 2
    for color in (False, True):
        for h in (H, max(1, r)):
            data = clip(color, seed=2, h=h)

            def make(M, v, **d):
                return M.FilterBlur(M.FilterNormalize(v, **d), sigma, ksize)

            got, ref = run_both(make, data, 4)
            x = np.clip((data.astype(f32) - f32(0)) * (f32(1) / f32(255)), 0, 1)
            assert (x != np.rint(x)).any()
            want = np_blur_float(x, ksize, sigma)
            np.testing.assert_array_equal(valid(got), want)
            direct = gaussian_blur_plain(torch.from_numpy(x), ksize, sigma, channels_last=color)
            np.testing.assert_array_equal(direct.numpy(), want)
            tol = r * np.spacing(f32(1.0))
            np.testing.assert_allclose(valid(got), valid(ref), rtol=0, atol=tol)


def test_monochrome_equal_channels_is_exact():
    """A BGR frame of three equal gray channels comes back as the gray
    frame, every value 0..255: the chain route at full width is pinned to
    the OpenCV reference's CSV through it."""
    v = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    bgr = np.repeat(v[..., None], 3, axis=-1)
    for n, out in tf.FilterMonochrome(VideoMemory(bgr), device=CPU).iter_batches(1):
        np.testing.assert_array_equal(out[:n], v)


def test_resize_taps_equal_jax_weights():
    """resize_taps reproduce jax.image.resize's weight matrix (as jitted on
    the CPU at these sizes) bit for bit."""
    for m, n in ((37, 18), (37, 55), (53, 26), (53, 80), (53, 79), (37, 20), (7, 3)):
        lo, hi, wlo, whi = tf.resize_taps(m, n)
        w = np.zeros((m, n), f32)
        w[lo, np.arange(n)] += wlo
        w[hi, np.arange(n)] += whi
        np.testing.assert_array_equal(w, jax_weights(m, n), err_msg=f"{m} -> {n}")


def test_pinned_copies():
    assert tf.QUADRANTS == jf.QUADRANTS
    np.testing.assert_array_equal(tf._BGR_WEIGHTS, jf._BGR_WEIGHTS)
    for ksize in (1, 3, 5, 7, 9, 11, 31):
        for sigma in (0.0, 0.7, 2.5):
            np.testing.assert_array_equal(gaussian_kernel_1d(ksize, sigma),
                                          jops.gaussian_kernel_1d(ksize, sigma))


# --------------------------------------------------- access and state
def test_get_frame_matches_tpuva():
    """get_frame applies this filter to source.get_frame(index), per
    filter: equal to tpuva's for each non-sequential filter (the
    contracting ones to numpy's source order on that frame)."""
    for color in (False, True):
        data = clip(color, seed=3)
        for name, make in EXACT.items():
            if color and name in GRAY_ONLY:
                continue
            p, j = make(tf, VideoMemory(data), device=CPU), make(jf, JVideoMemory(data))
            if p.sequential_only:
                continue
            for i in (0, 4, 8):
                np.testing.assert_array_equal(p.get_frame(i), j.get_frame(i), err_msg=name)
        for name, (make, reference, colors) in CONTRACTING.items():
            if color not in colors:
                continue
            p = make(tf, VideoMemory(data), device=CPU)
            if p.sequential_only:
                continue
            np.testing.assert_array_equal(p.get_frame(6), reference(data[6:7])[0], err_msg=name)


def test_sequential_only_and_first_batch_drop():
    data = clip()
    p = tf.FilterBackground(VideoMemory(data), device=CPU)
    with pytest.raises(NotImplementedError):
        p.get_frame(0)
    with pytest.raises(NotImplementedError):  # inside a chain too
        tf.FilterFlip(p).get_frame(0)
    # the time difference drops one row of the first batch only
    td = tf.FilterFlip(tf.FilterTimeDifference(VideoMemory(data), device=CPU))
    assert td.frame_count == T - 1 and td.chain_drop == 1
    assert [n for n, _ in td.iter_batches(4, pad_last=True)] == [3, 4, 2]
    assert valid(batches(td, 4)).shape[0] == T - 1


def test_background_carries_state_over_three_batches():
    """FilterBackground over three batches equals one pass over the whole
    clip (its state carried), numpy's source order, and tpuva's within the
    stated tolerance."""
    data = clip(seed=4, t=12)
    make = CONTRACTING["background_u8"][0]
    got, ref = run_both(make, data, 4)
    assert len(got) == 3
    one = batches(make(tf, VideoMemory(data), device=CPU), 12)
    np.testing.assert_array_equal(valid(got), valid(one))
    np.testing.assert_array_equal(valid(got), np_background(data, 0.05))
    assert_u8_close(valid(got), valid(ref), "background over three batches")


def test_device_defaults_and_inheritance(monkeypatch):
    v = VideoMemory(clip())
    inner = tf.FilterCrop(v, "upper left", device=CPU)
    assert tf.FilterBlur(inner, 0.0, 3).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.FilterCrop(v, "upper left")  # the default is the card


# ------------------------------------------------------------ the stager
class Decoder(VideoBase):
    """A stand-in decoder: frames only through get_frame (the stager sends
    it through the native ring)."""

    def __init__(self, data):
        super().__init__(len(data), (data.shape[2], data.shape[1]), 25.0, data.ndim == 4)
        self.data = data

    def get_frame(self, index):
        return self.data[index]


def no_frame_reads(chain):
    """chain with every filter's get_frame raising: the stager must run the
    chain's program on batches of its root instead."""
    def refuse(index):
        raise AssertionError("the chain was read frame by frame")

    node = chain
    while isinstance(node, tf.FilterBase):
        node.get_frame = refuse
        node = node.source
    return chain


CHAINS = {
    "time_difference_crop": lambda M, v, **d: M.FilterTimeDifference(
        M.FilterCrop(v, (3, 5, 20, 17), **d)),
    "blur_crop_bgr": lambda M, v, **d: M.FilterBlur(M.FilterCrop(v, (3, 5, 20, 17), **d), 0.0, 5),
}


@pytest.mark.parametrize("root", ["memory", "decoder"])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_stager_runs_chain_by_root(name, root):
    """BatchStager over a chain stages its root's frames (the feeder the
    root picks: a VideoMemory the Python feeder, a decoder the native ring)
    and runs the chain's program once a batch: the batches of tpuva's
    FilterBase.iter_batches(pad_last=True) (its stager's), bit for bit."""
    color = name.endswith("bgr")
    data = clip(color, seed=5, t=11)
    src = VideoMemory(data) if root == "memory" else Decoder(data)
    chain = no_frame_reads(CHAINS[name](tf, src, device=CPU))
    ref = batches(CHAINS[name](jf, JVideoMemory(data)), 4)
    st = BatchStager(chain, 4, device=CPU)
    assert st.native == (root == "decoder")
    runs = tf.run_chain.runs
    try:
        got = [(n, b.numpy().copy()) for n, b in st]
    finally:
        st.close()
    assert tf.run_chain.runs - runs == len(ref) == 3
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (n, a), (_n, b) in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)  # the padded rows too


def test_stager_chain_state_and_errors():
    """A stateful chain through the stager equals its own iter_batches;
    an error in the chain reaches the consumer."""
    data = clip(seed=6, t=11)
    chain = tf.FilterBackground(tf.FilterBlur(VideoMemory(data), 0.0, 3, device=CPU), 0.05)
    st = BatchStager(chain, 4, device=CPU)
    try:
        got = [(n, b.numpy().copy()) for n, b in st]
    finally:
        st.close()
    ref = batches(chain, 4)
    assert [n for n, _ in got] == [n for n, _ in ref]
    np.testing.assert_array_equal(valid(got), valid(ref))
    st = BatchStager(tf.FilterMedian(tf.FilterFunction(VideoMemory(data), refuse, device=CPU)),
                     4, device=CPU)
    with pytest.raises(ValueError, match="refused"):
        try:
            list(st)
        finally:
            st.close()


def refuse(frame):
    raise ValueError("refused")


# ------------------------------------------------------ the pipelines
def pipeline_cfg(module, batch=8):
    return module.PipelineConfig(
        background=module.BackgroundConfig(alpha=0.03),
        blur=module.BlurConfig(ksize=3),
        segment=module.SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
        track=module.TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=batch,
    )


def disk_clip(seed, frames=20):
    """A moving disk as gray frames, its plate, and the same as BGR of
    three equal channels (FilterMonochrome returns the gray frames)."""
    gray, _truth, plate = moving_disk_clip(h=64, w=96, frames=frames, radius=6, seed=seed)
    return gray, plate, np.repeat(gray[..., None], 3, axis=-1)


PIPELINE_CHAINS = {
    "monochrome_bgr": (lambda M, g, b, **d: M.FilterMonochrome(b, **d), lambda p: p),
    "crop_gray": (lambda M, g, b, **d: M.FilterCrop(g, (8, 4, 80, 56), **d),
                  lambda p: p[4:60, 8:88]),
}


@pytest.mark.parametrize("name", sorted(PIPELINE_CHAINS))
def test_streaming_pipeline_over_chain_matches_tpuva(name):
    make, plate_of = PIPELINE_CHAINS[name]
    gray, plate, bgr = disk_clip(seed=30)
    rows = StreamingPipeline(pipeline_cfg(tcfg), device=CPU).run(
        make(tf, VideoMemory(gray), VideoMemory(bgr), device=CPU), background0=plate_of(plate))
    rows_j = JStreamingPipeline(pipeline_cfg(jcfg)).run(
        make(jf, JVideoMemory(gray), JVideoMemory(bgr)), background0=plate_of(plate))
    assert rows == rows_j and rows


def test_multistream_pipeline_over_chains_matches_tpuva():
    """Two streams, each a chain (one BGR through FilterMonochrome, one gray
    cropped), through MultiStreamPipeline: tpuva's rows and merged rows."""
    streams = [disk_clip(seed=40), disk_clip(seed=41)]
    plates = np.stack([s[1][4:60, 8:88] for s in streams]).astype(np.float32)

    def chains(M, VM, **d):
        return [M.FilterCrop(M.FilterMonochrome(VM(streams[0][2]), **d), (8, 4, 80, 56)),
                M.FilterCrop(VM(streams[1][0]), (8, 4, 80, 56), **d)]

    rows, merged = MultiStreamPipeline(pipeline_cfg(tcfg), 2, device=CPU).run(
        chains(tf, VideoMemory, device=CPU), background0=plates)
    rows_j, merged_j = jd.MultiStreamPipeline(pipeline_cfg(jcfg), 2, mesh=None).run(
        chains(jf, JVideoMemory), background0=plates)
    assert rows == rows_j and merged == merged_j and all(rows)
