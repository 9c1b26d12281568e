"""The port's plain front-end ops (tpuva_torch.ops.filters/background)
against tpuva.ops on the same numpy inputs. Every comparison is exact:
the blur, median and morphology are integer-valued, threshold is a
compare, and the background update is the same float32 op sequence. The
copied numpy helpers are pinned to their originals."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuva.ops.filters as jf
from tpuva.ops.background import background_update as jax_bg_update
from tpuva_torch.ops import filters as tf
from tpuva_torch.ops.background import background_update
from test_torch_kernels import one_torch_thread  # noqa: F401

SHAPES = [(2, 17, 23), (1, 64, 96), (3, 5, 4), (1, 1, 7)]


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    # uint8 extremes: saturated blocks beside zeros maximise every blur sum
    x[..., : shape[-2] // 2, : shape[-1] // 2] = 255
    x[..., : shape[-2] // 4, : shape[-1] // 4] = 0
    return x


def test_numpy_helpers_match_originals():
    assert tf._SMALL_GAUSSIAN == jf._SMALL_GAUSSIAN
    for k in range(1, 32, 2):
        for s in (0.0, 0.5, 1.1, 2.0, 4.5, 10.0):
            np.testing.assert_array_equal(
                tf._gaussian_kernel_1d_f64(k, s), jf._gaussian_kernel_1d_f64(k, s)
            )
            np.testing.assert_array_equal(
                tf.u8_gaussian_taps(k, s), jf.u8_gaussian_taps(k, s)
            )
            assert tf.is_binomial_blur(k, s) == jf.is_binomial_blur(k, s)
    for shape in ("rect", "ellipse"):
        for k in (1, 3, 5, 7, 9, 11, 15):
            np.testing.assert_array_equal(
                tf.structuring_element(shape, k), jf.structuring_element(shape, k)
            )


def test_reflect101_index_matches_numpy_pad():
    for n in (1, 2, 3, 5, 8):
        for r in (0, 1, 3, 7, 12):
            ref = np.pad(np.arange(n), r, mode="reflect") if n > 1 else np.zeros(n + 2 * r, int)
            np.testing.assert_array_equal(tf.reflect101_index(n, -r, n + r), ref)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9, 11, 15])
def test_gaussian_blur_u8_matches_tpuva(ksize):
    for sigma in (0.0, 0.8, 1.5, 3.0):
        for i, shape in enumerate(SHAPES):
            x = _frames(shape, 100 * ksize + i)
            ref = np.asarray(
                jf.gaussian_blur_u8(jnp.asarray(x, jnp.float32), ksize, sigma)
            )
            got = tf.gaussian_blur_u8(torch.from_numpy(x), ksize, sigma).numpy()
            np.testing.assert_array_equal(got, ref, err_msg=f"{shape} s={sigma}")


def test_blur_taps_regimes():
    """The three regimes of the JAX op as one integer form."""
    assert tf.blur_taps(5, 0.0) == ((1, 4, 6, 4, 1), 8)
    assert tf.blur_taps(3, 0.0) == ((1, 2, 1), 4)
    assert tf.blur_taps(7, 0.0) == ((2, 7, 14, 18, 14, 7, 2), 12)
    assert tf.blur_taps(9, 0.0) == ((4, 13, 30, 51, 60, 51, 30, 13, 4), 16)
    taps, s = tf.blur_taps(5, 1.5)
    assert s == 16 and sum(taps) == 256
    assert tf.blur_taps(1, 0.0) == ((1,), 0)


def test_median3_matches_tpuva():
    for i, shape in enumerate(SHAPES):
        x = _frames(shape, 7 + i).astype(np.float32)
        ref = np.asarray(jf.median_blur(jnp.asarray(x), 3))
        got = tf.median_blur(torch.from_numpy(x), 3).numpy()
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(NotImplementedError):
        tf.median_blur(torch.zeros(1, 8, 8), 5)


def test_threshold_strict_at_the_edge():
    thr = 35.0
    t32 = np.float32(thr)
    x = np.array(
        [t32, np.nextafter(t32, np.float32(np.inf)), np.nextafter(t32, np.float32(0)),
         0.0, 255.0, 35.000001], np.float32,
    )
    ref = np.asarray(jf.threshold(jnp.asarray(x), thr))
    got = tf.threshold(torch.from_numpy(x), thr).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.uint8 and list(got[:3]) == [0, 255, 0]


@pytest.mark.parametrize("shape_name", ["rect", "ellipse"])
def test_morphology_matches_tpuva(shape_name):
    rng = np.random.default_rng(11)
    x = ((rng.random((2, 40, 53)) < 0.45) * 255).astype(np.uint8)
    x[0, :3, :] = 255  # foreground touching the border
    for k in (3, 5):
        se = jf.structuring_element(shape_name, k)
        for iters in (1, 2):
            for name in ("erode", "dilate", "morph_open", "morph_close"):
                ref = np.asarray(getattr(jf, name)(jnp.asarray(x), se, iters))
                got = getattr(tf, name)(torch.from_numpy(x), se, iters).numpy()
                np.testing.assert_array_equal(got, ref, err_msg=f"{name} k={k} it={iters}")


def test_background_update_matches_tpuva_and_numpy():
    rng = np.random.default_rng(5)
    bg = rng.uniform(0, 255, (33, 47)).astype(np.float32)
    f = rng.integers(0, 256, (33, 47)).astype(np.float32)
    for alpha in (0.02, 0.05, 0.3, 1e-3):
        got = background_update(torch.from_numpy(bg), torch.from_numpy(f), alpha).numpy()
        a = np.float32(alpha)
        np.testing.assert_array_equal(got, (np.float32(1) - a) * bg + a * f)
        ref = np.asarray(jax_bg_update(jnp.asarray(bg), jnp.asarray(f), alpha))
        np.testing.assert_array_equal(got, ref)
