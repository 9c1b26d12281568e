"""The port's analysis copies (tpuva_torch/analysis/) and debug.py against
tpuva's on the CPU.

image.py, shapes.py, regions.py and active_contour.py are numpy (and cv2
where tpuva calls it): every function and class equals tpuva's on the same
inputs, exactly. ``regions.mask_boundary`` takes a tensor (its 3 x 3 rect
erode is ``ops.filters.erode`` on the CPU, kernel K1m on a card) and equals
tpuva's. debug.py's headless dumps write the PNG bytes tpuva's do, under a
TPUVA_DEBUG_DIR of the test's own.
"""

import numpy as np
import pytest
import torch

import tpuva.analysis as janalysis
import tpuva.analysis.active_contour as jac
import tpuva.analysis.image as jimage
import tpuva.analysis.regions as jregions
import tpuva.analysis.shapes as jshapes
import tpuva.debug as jdebug
import tpuva_torch.analysis as tanalysis
import tpuva_torch.analysis.active_contour as tac
import tpuva_torch.analysis.image as timage
import tpuva_torch.analysis.regions as tregions
import tpuva_torch.analysis.shapes as tshapes
import tpuva_torch.debug as tdebug
from tpuva.io.memory import VideoMemory as JVideoMemory
from tpuva_torch.io.memory import VideoMemory
from test_torch_kernels import one_torch_thread  # noqa: F401


def same(a, b):
    """Equal results, recursively: arrays bit for bit, NaN equal to NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b and type(a) is type(b)


def image(seed=0, h=37, w=53):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    disk = ((yy - 18) ** 2 + (xx - 25) ** 2 < 100) * 150.0
    return (disk + rng.normal(40, 5, (h, w))).astype(np.float32)


def test_exports():
    for name in ("Rectangle", "Circle", "Ellipse", "ActiveContour"):
        assert getattr(tanalysis, name).__name__ == getattr(janalysis, name).__name__
    assert tanalysis.Rectangle is tregions.Rectangle and tanalysis.ActiveContour is tac.ActiveContour


def test_image_functions_match_tpuva():
    img = image()
    mask = img > 100
    for m in (None, mask, np.zeros_like(mask)):
        same(timage.get_image_statistics(img, m), jimage.get_image_statistics(img, m))
    for p0, p1, count in (((2.5, 3.0), (40.2, 30.7), None), ((0, 0), (52, 36), 17),
                          ((-3, 5), (60, 5), 9)):
        same(timage.line_scan(img, p0, p1, count), jimage.line_scan(img, p0, p1, count))
    xs = np.linspace(-2, 55, 31)
    ys = np.linspace(40, -3, 31)
    for im in (img, img[:, :1], img[:1, :], img[:1, :1]):
        same(timage.bilinear_sample(im, xs, ys), jimage.bilinear_sample(im, xs, ys))
    prof = timage.line_scan(img, (0, 18), (52, 18))
    for p in (prof, prof[::-1], np.ones(5), np.array([3.0, 1.0]), np.array([0.0, 1.0, 0.0])):
        same(timage.subpixel_peak_1d(p), jimage.subpixel_peak_1d(p))
        for d in (1, -1):
            same(timage.get_steepest_point(p, d), jimage.get_steepest_point(p, d))
    for patch in (img, img[10:25, 15:35], img[:2, :2]):
        same(timage.subpixel_peak_2d(patch), jimage.subpixel_peak_2d(patch))
    t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    curve = np.stack([25 + 10 * np.cos(t), 18 + 10 * np.sin(t)], axis=1)
    for nl, count in ((5.0, 11), (3.0, 7)):
        same(timage.measure_mean_profile(img, curve, nl, count),
             jimage.measure_mean_profile(img, curve, nl, count))


def test_shapes_match_tpuva():
    rng = np.random.default_rng(1)
    for mod in (tshapes, jshapes):
        assert mod.Circle(1.0, 2.0, 3.0).center == (1.0, 2.0)
    c_t, c_j = tshapes.Circle(10.0, 12.0, 5.0), jshapes.Circle(10.0, 12.0, 5.0)
    for attr in ("area", "perimeter", "center"):
        same(getattr(c_t, attr), getattr(c_j, attr))
    for p in ((10, 12), (14, 12), (20, 20)):
        same(c_t.contains_point(p), c_j.contains_point(p))
        same(c_t.distance_to_point(p), c_j.distance_to_point(p))
    same(c_t.polyline(17), c_j.polyline(17))
    for p0, p1 in (((0, 12), (1, 12)), ((0, 17), (1, 17)), ((0, 30), (1, 30)), ((3, 3), (3, 3))):
        same(c_t.intersect_line(p0, p1), c_j.intersect_line(p0, p1))
    pts = c_t.polyline(50) + rng.normal(0, 0.2, (50, 2))
    assert vars(tshapes.Circle.fit(pts)) == vars(jshapes.Circle.fit(pts))
    e_t, e_j = tshapes.Ellipse(10.0, 8.0, 6.0, 3.0, 0.4), jshapes.Ellipse(10.0, 8.0, 6.0, 3.0, 0.4)
    for attr in ("area", "eccentricity", "center"):
        same(getattr(e_t, attr), getattr(e_j, attr))
    same(tshapes.Ellipse(0, 0, 0, 0, 0).eccentricity, jshapes.Ellipse(0, 0, 0, 0, 0).eccentricity)
    for p in ((10, 8), (15, 10), (10, 12), (30, 30)):
        same(e_t.contains_point(p), e_j.contains_point(p))
    same(e_t.polyline(23), e_j.polyline(23))
    pts = e_t.polyline(60) + rng.normal(0, 0.1, (60, 2))
    assert vars(tshapes.Ellipse.fit(pts)) == vars(jshapes.Ellipse.fit(pts))
    mask = image() > 100
    for m in (mask, np.zeros_like(mask)):
        assert vars(tshapes.Ellipse.from_moments(m)) == vars(jshapes.Ellipse.from_moments(m))


def test_regions_match_tpuva():
    R_t, R_j = tregions.Rectangle, jregions.Rectangle
    pairs = [(R_t(2, 3, 10, 6), R_j(2, 3, 10, 6)), (R_t(5.5, -1, 4, 20), R_j(5.5, -1, 4, 20)),
             (R_t(50, 50, 1, 1), R_j(50, 50, 1, 1)), (R_t(0, 0, 0, 4), R_j(0, 0, 0, 4))]
    for a_t, a_j in pairs:
        for attr in ("left", "right", "top", "bottom", "corners", "center", "area", "is_empty"):
            same(getattr(a_t, attr), getattr(a_j, attr))
        assert vars(a_t.buffer(1.5)) == vars(a_j.buffer(1.5))
        assert vars(a_t.translate(2, -1)) == vars(a_j.translate(2, -1))
        assert vars(a_t.scale(0.5)) == vars(a_j.scale(0.5))
        assert vars(a_t.clip_to(12, 9)) == vars(a_j.clip_to(12, 9))
        assert vars(a_t.to_int()) == vars(a_j.to_int())
        assert a_t.slices() == a_j.slices()
        for p in ((3, 4), (12, 9), (5.5, 0)):
            assert a_t.contains_point(p) == a_j.contains_point(p)
        for b_t, b_j in pairs:
            assert vars(a_t.intersection(b_t)) == vars(a_j.intersection(b_j))
            assert vars(a_t.union(b_t)) == vars(a_j.union(b_j))
            assert a_t.intersects(b_t) == a_j.intersects(b_j)
            same(a_t.overlap_fraction(b_t), a_j.overlap_fraction(b_j))
    assert vars(R_t.from_points((7, 2), (1, 9))) == vars(R_j.from_points((7, 2), (1, 9)))
    assert vars(R_t.from_centerpoint((5, 5), 4, 2)) == vars(R_j.from_centerpoint((5, 5), 4, 2))
    mask = image() > 100
    for m in (mask, np.zeros_like(mask)):
        assert vars(R_t.from_mask(m)) == vars(R_j.from_mask(m))
    assert vars(tregions.corners_to_rect((1, 2), (5, 7))) == vars(
        jregions.corners_to_rect((1, 2), (5, 7)))
    r_t, r_j = pairs[0]
    assert tregions.rect_to_corners(r_t) == jregions.rect_to_corners(r_j)
    assert tregions.rect_to_slices(r_t) == jregions.rect_to_slices(r_j)
    assert vars(tregions.expand_rectangle(r_t, 2)) == vars(jregions.expand_rectangle(r_j, 2))
    pts = np.random.default_rng(2).normal(20, 6, (40, 2))
    same(tregions.get_enclosing_outline(pts), jregions.get_enclosing_outline(pts))
    same(tregions.mask_to_contours(mask), jregions.mask_to_contours(mask))
    contour = tregions.mask_to_contours(mask)[0]
    same(tregions.contour_to_mask(contour, mask.shape), jregions.contour_to_mask(contour, mask.shape))


@pytest.mark.parametrize("shape", [(37, 53), (3, 37, 53), (2, 2, 9, 7)])
def test_mask_boundary_matches_tpuva(shape):
    rng = np.random.default_rng(3)
    m = (rng.random(shape) < 0.6).astype(np.uint8) * rng.integers(1, 256, shape).astype(np.uint8)
    m[..., :2, :] = 255  # a full edge: the constant border keeps it
    for x in (m, m > 0):
        got = tregions.mask_boundary(torch.from_numpy(x))
        assert got.dtype == torch.bool and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(jregions.mask_boundary(x)))


def test_active_contour_matches_tpuva():
    img = image(4)
    t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    curve = np.stack([25 + 13 * np.cos(t), 18 + 13 * np.sin(t)], axis=1)
    for kw in (dict(closed=True), dict(closed=False, max_iterations=5),
               dict(closed=True, blur_radius=0.0, window=1)):
        a_t, a_j = tac.ActiveContour(**kw), jac.ActiveContour(**kw)
        same(a_t.fit(curve, img), a_j.fit(curve, img))
        assert a_t.info == a_j.info
    a_t, a_j = tac.ActiveContour(), jac.ActiveContour()
    same(a_t.fit(curve[:2], img), a_j.fit(curve[:2], img))
    assert a_t.info == a_j.info


def test_debug_dumps_match_tpuva(tmp_path, monkeypatch):
    """Headless (no DISPLAY): show_image and show_video write the PNG bytes
    tpuva's do (a uint8 frame, a float image scaled to 0..255, a constant
    float image, a tensor), each under TPUVA_DEBUG_DIR."""
    monkeypatch.delenv("DISPLAY", raising=False)
    rng = np.random.default_rng(5)
    clip = rng.integers(0, 256, (20, 9, 11), dtype=np.uint8)
    images = [clip[0], image(), np.full((5, 6), 3.5, np.float32)]
    for sub, mod, video in (("port", tdebug, VideoMemory), ("tpuva", jdebug, JVideoMemory)):
        monkeypatch.setenv("TPUVA_DEBUG_DIR", str(tmp_path / sub))
        paths = [mod.show_image(im, title="frame a") for im in images]
        paths += mod.show_video(video(clip), title="clip", max_dump_frames=6)
        assert all(p.startswith(str(tmp_path / sub)) for p in paths)
        if sub == "port":
            paths.append(mod.show_image(torch.from_numpy(images[1])))
            port = paths
        else:
            paths.append(mod.show_image(images[1]))
            ref = paths
    assert len(port) == len(ref) == 3 + 7 + 1
    for p, r in zip(port, ref):
        assert open(p, "rb").read() == open(r, "rb").read()
