"""Kernels KE (the exact EDT), KM (BGR -> gray), KW (the affine warp) and KR
(the linear resize) on the CPU: what of them runs without a card.

- ``edt_model``, KE's algorithm in numpy (the column scans, the row
  search bounded by the best so far, the pass counts it reports), equals
  the plain pass loop ``edt_sq_passes_plain`` bit for bit with its passes,
  tpuva's ``distance_transform_edt_sq`` and scipy's EDT: random masks at
  densities 0.01 to 0.9 from one seed, columns and rows with no zero,
  all-foreground (+inf) and all-background masks, 1-px lines and single
  zeros, 37 x 301, leading axes.
- The launch plans: ``mono_plan`` (KM's 16-byte pieces, tails, unaligned
  slots), ``warp_plan`` (layouts, the float32 inverse map of the plain
  version) and KW's clamped floors, which give the plain version's int64
  corner masks and clamped indices for far-out coordinates, and KR's tap
  table and its cache on a device; KR's blocks (``tile_blocks``: every
  tile's staged rows and span cover its outputs' taps), ``resize_plan``
  (a tile gathers exactly where its footprint exceeds a buffer) and a
  numpy model of its staged route equal to the plain version.
- CPU calls of the public functions take the plain versions and leave
  every new kernel's counter at 0; the plain versions call no function
  that launches a kernel on a CUDA tensor.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import tpuva.ops as jops
from tpuva_torch import filters as tf
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.ops import color, distance, resize, warp
from tpuva_torch.scenes import edt_scenes
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_median import codes_called

f32 = np.float32


# ------------------------------------------------------------------ KE
EDT_CASES = edt_scenes()


@pytest.mark.parametrize("name", sorted(EDT_CASES))
def test_edt_model_equals_plain_tpuva_and_scipy(name):
    """KE's algorithm gives the plain loop's squared EDT and its pass
    counts bit for bit, tpuva's and scipy's; sqrt of it tpuva's EDT."""
    m = EDT_CASES[name]
    sq, passes = distance.edt_model(m)
    ref, ref_passes = distance.edt_sq_passes_plain(torch.from_numpy(m))
    assert sq.dtype == np.float32 and sq.shape == m.shape
    np.testing.assert_array_equal(sq, ref.numpy())
    assert passes == ref_passes
    np.testing.assert_array_equal(sq, np.asarray(jops.distance_transform_edt_sq(m)))
    np.testing.assert_array_equal(np.sqrt(sq), np.asarray(jops.distance_transform_edt(m)))
    flat = m.reshape((-1,) + m.shape[-2:])
    for k, frame in enumerate(flat):
        got = sq.reshape(flat.shape)[k]
        if (frame == 0).any():
            d = ndi.distance_transform_edt(frame)
            np.testing.assert_array_equal(got, np.round(d * d).astype(f32))
        else:
            assert np.isinf(got).all()


def test_edt_cpu_square_root_is_correctly_rounded():
    """distance_transform_edt on a CPU tensor equals tpuva's and scipy's
    where torch's float32 sqrt on the CPU can be one ulp off: squared
    distances up to 30^2 + 40^2 from one corner zero, 1421 among them."""
    m = EDT_CASES["lines_and_a_corner"][2]
    d = distance.distance_transform_edt(torch.from_numpy(m)).numpy()
    assert 1421 in np.round(d * d.astype(np.float64))
    np.testing.assert_array_equal(d, np.asarray(jops.distance_transform_edt(m)))
    np.testing.assert_array_equal(d, ndi.distance_transform_edt(m).astype(f32))


def test_edt_model_pass_counts():
    """The counts the kernel reports: 1 + the largest finite column
    distance, 1 + the largest offset of a finite output's last
    improvement (one zero at (4, 0) of a 9 x 12 mask: 5 and 12)."""
    m = np.ones((9, 12), np.uint8)
    m[4, 0] = 0
    assert distance.edt_model(m)[1] == (5, 12)
    assert distance.edt_model(np.ones((2, 5, 5), np.uint8))[1] == (1, 1)
    assert distance.edt_model(np.zeros((5, 5), np.uint8))[1] == (1, 1)


def test_edt_cpu_calls_take_the_plain_loop():
    """distance_transform_edt(_sq) and edt_sq_passes on CPU tensors, any
    dtype, equal the plain loop and launch nothing; edt_kernel refuses a
    CPU tensor."""
    m = EDT_CASES["density_0.2"]
    before = distance.edt_kernel.launches
    ref, passes = distance.edt_sq_passes_plain(torch.from_numpy(m))
    for dtype in (torch.uint8, torch.bool, torch.float32):
        x = torch.from_numpy(m).to(dtype)
        assert torch.equal(distance.distance_transform_edt_sq(x), ref)
        assert torch.equal(distance.distance_transform_edt(x),
                           torch.from_numpy(np.sqrt(ref.numpy())))
        got, got_passes = distance.edt_sq_passes(x)
        assert torch.equal(got, ref) and got_passes == passes
    assert distance.edt_kernel.launches == before
    with pytest.raises(ValueError):
        distance.edt_kernel(torch.from_numpy(m), False)


# ------------------------------------------------------------------ KM
@pytest.mark.parametrize("P,per,aligned", [
    (16 * 7, 16, True), (16 * 7 + 5, 16, True), (3, 16, True), (0, 16, True),
    (16 * 7 + 5, 16, False), (4 * 300 + 3, 4, True), (4 * 300 + 3, 4, False),
    (256 * 1080 * 1920, 16, True)])
def test_mono_plan_covers_every_pixel_once(P, per, aligned):
    """The vector path's pieces then the pixel path cover [0, P) once;
    unaligned input or output takes the pixel path throughout; the CTAs
    hold a thread a piece or pixel."""
    plan = color.mono_plan(P, per, aligned)
    assert plan.start == plan.pieces * per and plan.start <= P
    assert P - plan.start < (per if aligned else P + 1)
    if not aligned:
        assert plan.pieces == 0 and plan.start == 0
    assert plan.vec_blocks * color.KM_THREADS >= plan.pieces > (plan.vec_blocks - 1) * 256
    assert plan.px_blocks * color.KM_THREADS >= P - plan.start > (plan.px_blocks - 1) * 256


def test_bgr_to_gray_cpu_is_the_plain_version():
    """bgr_to_gray on CPU tensors is bgr_to_gray_plain (uint8 and float),
    with KM's counter untouched; its weights are tpuva's."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (3, 7, 11, 3), dtype=np.uint8)
    before = color.bgr_to_gray.launches
    for t in (torch.from_numpy(x), torch.from_numpy(x.astype(f32) + 0.25)):
        got = color.bgr_to_gray(t)
        assert got.dtype == t.dtype and torch.equal(got, color.bgr_to_gray_plain(t))
    assert color.bgr_to_gray.launches == before
    np.testing.assert_array_equal(color.BGR_WEIGHTS, tf._BGR_WEIGHTS)


# ------------------------------------------------------------------ KW
WARP_SHAPES = {"nhw": (4, 37, 53), "hw": (37, 53), "nhwc": (3, 37, 53, 3), "hwc": (37, 53, 3),
               "lead2_hwc": (2, 2, 37, 53, 3)}


@pytest.mark.parametrize("layout", sorted(WARP_SHAPES))
def test_warp_plan_layouts_and_inverse_map(layout):
    """warp_plan's images, channels, output shape and float32 inverse map
    are those of warp_affine_plain's torch ops."""
    shape = WARP_SHAPES[layout]
    M = warp.rotation_matrix((20.0, 11.0), -33.0, 1.2)
    for out_size, inverse in ((None, False), ((40, 30), True)):
        plan = warp.warp_plan(shape, M, out_size, inverse)
        img = torch.zeros(shape, dtype=torch.uint8)
        ref = warp.warp_affine_plain(img, M, out_size, inverse)
        assert plan.out_shape == tuple(ref.shape)
        chan = layout.endswith("hwc")
        assert plan.C == (3 if chan else 1)
        assert plan.L * plan.H * plan.W * plan.C == int(np.prod(shape))
        Mi = np.asarray(M) if inverse else warp.invert_affine(M)
        assert plan.coeffs == tuple(float(f32(v)) for v in Mi.reshape(-1))


def test_warp_clamped_floor_keeps_the_corner_masks_and_indices():
    """KW clamps the floor to [-2, W + 1] before its int conversion; for
    floors far outside the image (to +-1e30) every corner's border mask
    and clamped index equal those of the plain version's int64 floor."""
    W = 53
    floors = np.array([-1e30, -3e9, -70000.0, -3.0, -2.0, -1.0, 0.0, 1.0, 51.0, 52.0, 53.0,
                       54.0, 55.0, 1e5, 2.5e9, 1e30], f32)
    x64 = np.clip(floors.astype(np.float64), -2 ** 62, 2 ** 62).astype(np.int64)
    x32 = np.minimum(np.maximum(floors, f32(-2)), f32(W) + f32(1)).astype(np.int32)
    for d in (0, 1):  # the corners x0 and x0 + 1
        a, b = x64 + d, x32.astype(np.int64) + d
        np.testing.assert_array_equal((a >= 0) & (a < W), (b >= 0) & (b < W))
        np.testing.assert_array_equal(np.clip(a, 0, W - 1), np.clip(b, 0, W - 1))


def test_warp_affine_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    before = warp.warp_affine.launches
    for shape in WARP_SHAPES.values():
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        for kw in (dict(), dict(out_size=(40, 30), border_value=9.0),
                   dict(inverse=True, border="replicate")):
            M = [[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]]
            assert torch.equal(warp.warp_affine(x, M, **kw), warp.warp_affine_plain(x, M, **kw))
    assert warp.warp_affine.launches == before


# ------------------------------------------------------------------ KR
@pytest.mark.parametrize("m,n", [(37, 18), (37, 55), (53, 80), (1080, 540), (1920, 2880),
                                 (7, 3), (5, 5)])
def test_resize_tap_table_decodes_to_the_taps(m, n):
    """KR's (4, n) int32 table holds resize_taps' indices and the bits of
    their float32 weights; every index lies in [0, m)."""
    lo, hi, wlo, whi = resize.resize_taps(m, n)
    t = resize.tap_table(m, n)
    assert t.shape == (4, n) and t.dtype == np.int32
    np.testing.assert_array_equal(t[0], lo)
    np.testing.assert_array_equal(t[1], hi)
    np.testing.assert_array_equal(t[2].view(f32), wlo)
    np.testing.assert_array_equal(t[3].view(f32), whi)
    assert t[:2].min() >= 0 and t[:2].max() < m


def test_resize_device_taps_are_uploaded_once():
    """device_taps keeps one table a (m, n, device): the same tensor on a
    second call, equal to tap_table."""
    dev = torch.device("cpu")
    a = resize.device_taps(37, 55, dev)
    assert resize.device_taps(37, 55, dev) is a
    assert resize.device_taps(55, 37, dev) is not a
    np.testing.assert_array_equal(a.numpy(), resize.tap_table(37, 55))


def test_resize_linear_cpu_is_the_plain_version():
    """resize_linear and FilterResize on CPU tensors take
    resize_linear_plain (gray and BGR, uint8 and float, an axis kept), with
    KR's counter untouched."""
    rng = np.random.default_rng(6)
    before = resize.resize_linear.launches
    for shape in ((3, 37, 53), (2, 37, 53, 3)):
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        for size in ((26, 18), (80, 37), (53, 55), (53, 37)):
            for t in (torch.from_numpy(x), torch.from_numpy(x.astype(f32) / 7)):
                got = resize.resize_linear(t, size)
                assert torch.equal(got, resize.resize_linear_plain(t, size))
        out = next(tf.FilterResize(VideoMemory(x), (26, 18), device="cpu").iter_batches(8))[1]
        np.testing.assert_array_equal(out, resize.resize_linear_plain(torch.from_numpy(x),
                                                                      (26, 18)).numpy())
    assert resize.resize_linear.launches == before


KR_AXES = [(37, 18), (37, 55), (53, 80), (1080, 540), (1920, 960), (1080, 1620), (1920, 2880),
           (1920, 61), (7, 3), (1, 7), (7, 1), (5, 5), (37, 37), (301, 301)]


@pytest.mark.parametrize("m,n", KR_AXES, ids=[f"{m}to{n}" for m, n in KR_AXES])
@pytest.mark.parametrize("T", [resize.KR_TILE[0], resize.KR_TILE[1]])
def test_resize_tile_blocks_cover_every_tap(m, n, T):
    """Each block of T outputs records its outputs' distinct taps in
    ascending order, at most 2 T of them, and each output's slots name its
    lower and upper taps there: the rows a tile stages (or the span of its
    columns, first to last record) hold every tap of its outputs. Down, up
    and kept axes, odd sizes."""
    lo, hi = resize.resize_taps(m, n)[:2]
    t = resize.tile_blocks(m, n, T)
    nb = -(-n // T)
    assert t.dtype == np.int32 and t.shape == (n + nb * (1 + 2 * T),)
    recs = t[n:].reshape(nb, 1 + 2 * T)
    for b in range(nb):
        count, taps = recs[b, 0], recs[b, 1:1 + recs[b, 0]]
        assert 1 <= count <= 2 * T and (np.diff(taps) > 0).all()
        assert taps.min() >= 0 and taps.max() < m and not recs[b, 1 + count:].any()
        outs = np.arange(b * T, min(n, (b + 1) * T))
        np.testing.assert_array_equal(taps[t[outs] & 0xFFFF], lo[outs])
        np.testing.assert_array_equal(taps[t[outs] >> 16], hi[outs])
        assert set(taps) == set(lo[outs]) | set(hi[outs])
    if m == n:  # the identity, which the kernel skips
        np.testing.assert_array_equal(t[:n], np.arange(n) % T * 65537)


KR_PLANS = [((1080, 1920), (960, 540)), ((1080, 1920), (2880, 1620)), ((1080, 1920), (61, 540)),
            ((1080, 1920), (1920, 540)), ((1080, 1920), (960, 1080)), ((37, 53), (26, 18)),
            ((37, 53), (80, 37)), ((45, 301), (7, 90)), ((3, 5000), (40, 2))]


# (H, W), size, bytes a pixel, vec_in (only where the rows are 16-byte multiples)
KR_PLAN_CASES = [(hw, size, px, vec) for hw, size in KR_PLANS for px in (1, 3, 4, 12)
                 for vec in (True, False) if not vec or hw[1] * px % 16 == 0]


@pytest.mark.parametrize("hw,size,px,vec_in", KR_PLAN_CASES, ids=[
    f"{a[1]}x{a[0]}to{b[0]}x{b[1]}-{px}B-{'vec' if v else 'bytes'}"
    for a, b, px, v in KR_PLAN_CASES])
def test_resize_plan_routes(hw, size, px, vec_in):
    """resize_plan's footprint a tile is its rows' count times its span's
    bytes; the span holds every column tap's bytes (widened to 16-byte
    bounds on vec_in); a tile stages exactly where its footprint fits
    KR_BUF_MAX, and the buffer (a multiple of 16) is the largest such
    footprint; the CTAs over the images fill KR_CTAS."""
    H, W = hw
    w, h = size
    plan = resize.resize_plan(16, H, W, px, size, vec_in)
    tw, th = resize.KR_TILE
    assert plan.tiles == (-(-w // tw), -(-h // th))
    lo, hi = resize.resize_taps(W, w)[:2]
    for bx in range(plan.tiles[0]):
        cols = np.arange(bx * tw, min(w, (bx + 1) * tw))
        c0, c1 = min(lo[cols].min(), hi[cols].min()), max(lo[cols].max(), hi[cols].max())
        a0 = c0 * px & ~15 if vec_in else c0 * px
        assert a0 <= c0 * px and (c1 + 1) * px <= a0 + plan.pitch[bx] <= W * px
        assert plan.pitch[bx] % 16 == 0 if vec_in else plan.pitch[bx] == (c1 + 1 - c0) * px
    rows = resize.tile_blocks(H, h, th)[h:].reshape(-1, 1 + 2 * th)[:, 0]
    np.testing.assert_array_equal(plan.rows, rows)
    np.testing.assert_array_equal(plan.footprint, np.outer(rows, plan.pitch))
    np.testing.assert_array_equal(plan.staged, plan.footprint <= resize.KR_BUF_MAX)
    assert plan.buf % 16 == 0 and plan.buf <= resize.KR_BUF_MAX
    fits = plan.footprint[plan.staged]
    assert plan.buf == (-(-fits.max() // 16) * 16 if fits.size else 0)
    assert plan.grid_z == min(16, max(1, -(-resize.KR_CTAS // (plan.tiles[0] * plan.tiles[1]))))
    if size == (61, 540):  # a span of 64 columns is the whole row: 32 rows of it gather
        assert plan.staged[plan.rows < 2 * th].all() == (px == 1)
        assert not plan.staged[plan.rows == 2 * th].any()
    if size in ((960, 540), (2880, 1620)) and px <= 3:
        assert plan.staged.all()


def kr_model(x: np.ndarray, size, vec_in: bool) -> np.ndarray:
    """KR's staged route in numpy for a uint8 or float32 batch (N, H, W,
    C): per tile and image the rows of its record staged as bytes over its
    span, each output's two rows by its slots, its columns as byte
    offsets from the span's start, the H pass at both columns then the W
    pass, each float32 op rounded on its own; every tile stages."""
    N, H, W, C = x.shape
    w, h = size
    px = C * x.itemsize
    tw, th = resize.KR_TILE
    taps_h, taps_w = resize.tap_table(H, h), resize.tap_table(W, w)
    blocks_h = resize.tile_blocks(H, h, th)
    blocks_w = resize.tile_blocks(W, w, tw)
    xb = x.reshape(N, H, W * px).view(np.uint8) if x.itemsize == 1 else \
        x.reshape(N, H, W * C).view(np.uint8)
    out = np.zeros((N, h, w, C), np.float32)
    for by in range(-(-h // th)):
        rec_h = blocks_h[h + by * (1 + 2 * th):]
        rows = rec_h[1:1 + rec_h[0]]
        for bx in range(-(-w // tw)):
            rec_w = blocks_w[w + bx * (1 + 2 * tw):]
            a0, a1 = rec_w[1] * px, (rec_w[rec_w[0]] + 1) * px
            if vec_in:
                a0, a1 = a0 & ~15, (a1 + 15) & ~15
            for n in range(N):
                foot = xb[n, rows, a0:a1]  # (rows, pitch) bytes
                for yo in range(by * th, min(h, (by + 1) * th)):
                    slot = blocks_h[yo]
                    rlo, rhi = foot[slot & 0xFFFF], foot[slot >> 16]
                    wy = taps_h[2:, yo].view(f32)
                    for xo in range(bx * tw, min(w, (bx + 1) * tw)):
                        wx = taps_w[2:, xo].view(f32)
                        for c in range(C):
                            def at(row, col):
                                b = col * px - a0 + c * x.itemsize
                                return row[b:b + x.itemsize].view(x.dtype)[0].astype(f32)
                            t = []
                            for col in taps_w[:2, xo]:
                                v = at(rlo, col)
                                if h != H:
                                    v = f32(f32(v * wy[0]) + f32(at(rhi, col) * wy[1]))
                                t.append(v)
                            v = t[0]
                            if w != W:
                                v = f32(f32(t[0] * wx[0]) + f32(t[1] * wx[1]))
                            out[n, yo, xo, c] = v
    if x.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


@pytest.mark.parametrize("size", [(26, 18), (80, 37), (53, 55), (53, 37), (70, 9)])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_staged_model_matches_plain(size, C, dtype):
    """KR's staged route (kr_model: the records, slots and byte offsets the
    kernel reads) equals resize_linear_plain bit for bit on 37 x 53 frames:
    down, up, one axis kept; uint8 and float32; spans cut at 16-byte
    bounds (rows of 16-byte multiples) and exactly."""
    rng = np.random.default_rng(12)
    W = 64 if C == 1 else 48  # 16-byte rows, so that both spans apply
    x = rng.integers(0, 256, (2, 37, W, C)).astype(dtype)
    if dtype == np.float32:
        x += rng.random(x.shape, dtype=f32)
    ref = resize.resize_linear_plain(torch.from_numpy(x[..., 0] if C == 1 else x), size).numpy()
    for vec_in in (True, False):
        got = kr_model(x, size, vec_in)
        np.testing.assert_array_equal(got[..., 0] if C == 1 else got, ref)


# ------------------------------------------------------- plain stays plain
DISPATCHERS = [color.bgr_to_gray, warp.warp_affine, resize.resize_linear, distance.edt_kernel,
               distance.edt_sq_passes, distance.distance_transform_edt,
               distance.distance_transform_edt_sq]


def test_plain_versions_reach_no_dispatcher():
    """KE's, KM's, KW's and KR's plain versions call none of the functions
    that launch those kernels on a CUDA tensor, so on the card they stay
    the kernels' yardsticks; the profiler does see a dispatcher where one
    is called."""
    rng = np.random.default_rng(8)
    bgr = torch.from_numpy(rng.integers(0, 256, (2, 9, 13, 3), dtype=np.uint8))
    mask = torch.from_numpy((rng.random((2, 9, 13)) < 0.7).astype(np.uint8))
    M = [[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]]
    plain = {
        "bgr_to_gray_plain": lambda: color.bgr_to_gray_plain(bgr),
        "warp_affine_plain": lambda: warp.warp_affine_plain(bgr, M, out_size=(11, 7)),
        "resize_linear_plain": lambda: resize.resize_linear_plain(bgr, (20, 5)),
        "edt_sq_passes_plain": lambda: distance.edt_sq_passes_plain(mask),
    }
    dispatchers = {f.__code__: f.__qualname__ for f in DISPATCHERS}
    for name, fn in plain.items():
        hit = sorted(dispatchers[c] for c in codes_called(fn) if c in dispatchers)
        assert not hit, f"{name} reached {hit}"
    assert warp.warp_affine.__code__ in codes_called(lambda: warp.warp_affine(bgr, M))


def test_cpu_chain_leaves_every_new_counter_at_zero():
    """A CPU chain through FilterMonochrome, FilterRotate(angle=),
    FilterWarpAffine and FilterResize, and the EDT of its output, launch
    no kernel."""
    counters = (color.bgr_to_gray, warp.warp_affine, resize.resize_linear, distance.edt_kernel)
    before = [f.launches for f in counters]
    x = np.random.default_rng(9).integers(0, 256, (5, 21, 34, 3), dtype=np.uint8)
    chain = tf.FilterResize(tf.FilterWarpAffine(tf.FilterRotate(tf.FilterMonochrome(
        VideoMemory(x), device="cpu"), angle=7.5), [[0.9, 0.1, 2.5], [-0.2, 1.1, -3.25]]),
        (17, 30))
    out = np.concatenate([o[:n] for n, o in chain.iter_batches(2, pad_last=True)])
    assert out.shape == (5, 30, 17) and out.dtype == np.uint8
    distance.distance_transform_edt(torch.from_numpy(out > 100))
    assert [f.launches for f in counters] == before
