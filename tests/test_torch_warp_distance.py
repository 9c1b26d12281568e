"""The port's warp and distance ops (tpuva_torch/ops/warp.py, ops/distance.py)
against tpuva's on the CPU.

``rotation_matrix`` and ``invert_affine`` are host float64 copies: bit-equal.
``warp_affine`` on gray (N, H, W) and (H, W) and colour (N, H, W, 3) and
(H, W, 3), both borders, ``inverse``, ``out_size``, uint8 and float32:
bit-equal to a numpy float32 evaluation of tpuva's expression in source
order (tests/test_torch_filter_chain.py's ``np_warp``), and to tpuva within
the stated tolerance, since tpuva's XLA:CPU run contracts some of its
products and sums into FMAs (ROADMAP Queue 3 R5): uint8 at most 1 apart on
at most U8_SHARE of the pixels; float32 within the roundings of the sample
coordinates (a shift of fx or fy by an ulp of the largest coordinate moves
a sample by that times the image's range) and of the three lerps. The EDT
and its squared form: bit-equal to tpuva's and to
scipy.ndimage.distance_transform_edt, batched, and +inf without a seed.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import tpuva.ops as jops
from tpuva_torch import ops as tops
from tpuva_torch.ops.distance import edt_sq_passes
from test_torch_filter_chain import assert_u8_close, np_warp
from test_torch_kernels import one_torch_thread  # noqa: F401

f32 = np.float32


def test_rotation_matrix_and_invert_affine_bit_equal():
    for center, angle, scale in (((26.0, 18.0), 7.5, 1.0), ((0.5, -3.0), -33.0, 0.8),
                                 ((959.5, 539.5), 90.0, 1.0), ((10, 10), 0.0, 2.0)):
        M = tops.rotation_matrix(center, angle, scale)
        np.testing.assert_array_equal(M, jops.rotation_matrix(center, angle, scale))
        np.testing.assert_array_equal(tops.invert_affine(M), jops.invert_affine(M))
    for M in (np.array([[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]]), [[2, 0, 1], [0, 3, -1]]):
        np.testing.assert_array_equal(tops.invert_affine(M), jops.invert_affine(M))
    for inv in (tops.invert_affine, jops.invert_affine):
        with pytest.raises(ValueError):
            inv([[1, 2, 0], [2, 4, 0]])


M_SHEAR = np.array([[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]])
WARPS = {
    "rotate": dict(M=tops.rotation_matrix((26.0, 18.0), 7.5)),
    "shear_out_size": dict(M=M_SHEAR, out_size=(40, 30), border_value=17.0),
    "inverse": dict(M=M_SHEAR, inverse=True),
    "replicate": dict(M=tops.rotation_matrix((20.0, 11.0), -33.0, 1.2), border="replicate"),
    "upscale_out_size": dict(M=np.array([[1.7, 0.0, -4.0], [0.0, 1.3, 2.0]]), out_size=(71, 45)),
}
LAYOUTS = {"nhw": (4, 37, 53), "hw": (37, 53), "nhwc": (3, 37, 53, 3), "hwc": (37, 53, 3)}


def warp_tolerance(img, M, out_size, inverse):
    """float32: the coordinates' two rounding steps an axis, each at most
    half an ulp of the largest coordinate, times twice the image's range
    (two lerps an axis), plus the three lerps' roundings, each at most half
    an ulp of the image's largest magnitude."""
    h, w = img.shape[-3:-1] if img.shape[-1] == 3 and img.ndim >= 3 else img.shape[-2:]
    wo, ho = out_size if out_size is not None else (w, h)
    Mi = np.asarray(M, np.float64) if inverse else jops.invert_affine(M)
    corners = np.array([[0, 0, 1], [wo, 0, 1], [0, ho, 1], [wo, ho, 1]], np.float64)
    coord = float(np.abs(corners @ Mi.T).max()) + 1
    peak = float(np.abs(img).max())
    span = float(img.max()) - float(img.min())
    return 2 * np.spacing(f32(coord)) * 2 * span + 3 * np.spacing(f32(peak))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(WARPS))
def test_warp_affine_source_order_and_tolerance(name, layout, dtype):
    kw = WARPS[name]
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, LAYOUTS[layout]).astype(dtype)
    if dtype == "float32":
        img = img + rng.random(img.shape, dtype=f32)
    got = tops.warp_affine(torch.from_numpy(img), **kw)
    assert got.dtype == torch.from_numpy(img).dtype
    got = got.numpy()
    np.testing.assert_array_equal(got, np_warp(img, **kw))
    ref = np.asarray(jops.warp_affine(img, **kw))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if dtype == "uint8":
        assert_u8_close(got, ref, name)
    else:
        tol = warp_tolerance(img, kw["M"], kw.get("out_size"), kw.get("inverse", False))
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def masks(seed=0):
    """(6, 37, 53) uint8 masks of densities 0.1..0.95, one all-foreground
    frame (no seed anywhere) and one empty frame."""
    rng = np.random.default_rng(seed)
    dens = np.array([0.1, 0.5, 0.9, 0.95, 1.0, 0.0])[:, None, None]
    return (rng.random((6, 37, 53)) < dens).astype(np.uint8)


@pytest.mark.parametrize("dtype", ["uint8", "bool", "float32"])
def test_edt_matches_tpuva_and_scipy(dtype):
    m = masks().astype(dtype)
    sq = tops.distance_transform_edt_sq(torch.from_numpy(m)).numpy()
    d = tops.distance_transform_edt(torch.from_numpy(m)).numpy()
    assert sq.dtype == d.dtype == np.float32
    np.testing.assert_array_equal(sq, np.asarray(jops.distance_transform_edt_sq(m)))
    np.testing.assert_array_equal(d, np.asarray(jops.distance_transform_edt(m)))
    assert np.isinf(d[4]).all() and (d[5] == 0).all()  # no seed; all seeds
    for k in (0, 1, 2, 3, 5):
        ref = ndi.distance_transform_edt(m[k])
        np.testing.assert_array_equal(d[k], ref.astype(f32))
        np.testing.assert_array_equal(sq[k], np.round(ref * ref).astype(f32))


def test_edt_single_frame_and_passes():
    """A 2D mask; the passes each stage took: one more than the largest
    distance along its axis that it had to cover (the last pass changes
    nothing)."""
    m = np.ones((9, 12), np.uint8)
    m[4, 0] = 0
    sq, (cols, rows) = edt_sq_passes(torch.from_numpy(m))
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jops.distance_transform_edt_sq(m)))
    # column 0 reaches 4 rows from its seed; the rows reach 11 columns
    assert (cols, rows) == (5, 12)
    _sq, passes = edt_sq_passes(torch.ones((2, 5, 5), dtype=torch.uint8))
    assert passes == (1, 1) and torch.isinf(_sq).all()
