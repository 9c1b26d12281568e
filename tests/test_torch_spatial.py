"""The port's spatial processor (tpuva_torch.dist.spatial: one stream banded
by rows over a mesh of devices, here 2, 3 and 4 bands on the CPU) against
the port's single-device process_batch and tpuva's make_spatial_processor
on the simulated CPU mesh (tests/conftest.py gives JAX 8 devices).

Against the port's process_batch every output, the carried background and
the track table are bit-equal: the band front end is K1's plain version on
each band's rows plus an interior halo, the band CCL and merge give the
single-device stats. Against tpuva the rows, sums, stats_overflow and
tp_recon_rounds are equal and the background within rtol 1e-5 (XLA:CPU
FMA-contracts tpuva's update, ROADMAP Queue 3, R1). The scenes are tpuva's
three (tests/test_spatial_tp.py) and an odd band height (H = 90 on 2
bands: a 2 x 2 block of the global scan keys straddles the bands); each
tpuva program runs once a module, through the `tpuva_runs` fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import tpuva.dist.spatial as jsp
import tpuva.graph.config as jcfg
import tpuva.graph.pipeline as jpl
from refimpl.synthetic import moving_disk_clip
from tpuva.ops.label import _segmented_min_scan as j_segmented_min_scan
from tpuva_torch.dist.spatial import _halo_rows, make_space_mesh, make_spatial_processor
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph.pipeline import _front_end_emit, init_carry, process_batch, torch_front_end
from tpuva_torch.ops.label import _segmented_min_scan
from tpuva_torch.track.table import TrackState
from test_torch_kernels import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
OUT_KEYS = ("rows", "row_valid", "row_sums", "n_det", "active_tracks", "stats_overflow")


def cfg(module, kind):
    """tpuva's test configs: "fixed" and "otsu" (tests/test_spatial_tp.py:20,
    :112), "bare" the adversarial scene's (no filter, alpha 0)."""
    if kind == "bare":
        return module.PipelineConfig(
            background=module.BackgroundConfig(alpha=0.0),
            segment=module.SegmentConfig(threshold=40.0, min_area=2, max_blobs=8),
            track=module.TrackConfig(max_dist=80.0, death_patience=3, max_tracks=16),
            batch=4,
        )
    otsu = kind == "otsu"
    return module.PipelineConfig(
        background=module.BackgroundConfig(alpha=0.05),
        blur=module.BlurConfig(ksize=5, sigma=0.0),
        morph_open=module.MorphConfig(ksize=3, shape="rect"),
        morph_close=None if otsu else module.MorphConfig(ksize=3, shape="ellipse"),
        segment=module.SegmentConfig(threshold="otsu" if otsu else 35.0, min_area=20,
                                     max_blobs=4),
        track=module.TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=8,
    )


def adversarial_clip():
    """tpuva's band-spanning scene (tests/test_spatial_tp.py:62): a U whose
    arms are separate pieces inside the middle bands, a line through every
    band, speckle noise."""
    H, W, T = 96, 128, 8
    rng = np.random.default_rng(20)
    clip = np.zeros((T, H, W), np.uint8)
    clip[:, 10:80, 20:24] = 200
    clip[:, 10:80, 40:44] = 200
    clip[:, 10:14, 20:44] = 200
    clip[:, 0:96, 100:102] = 200
    noise = (rng.random((T, H, W)) > 0.995).astype(np.uint8) * 200
    return np.maximum(clip, noise), np.zeros((H, W), np.float32)


def disk_clip(H, W, T, seed):
    clip, _truth, plate = moving_disk_clip(h=H, w=W, frames=T, radius=9, noise_sigma=3.0,
                                           seed=seed)
    return clip, plate.astype(np.float32)


# name: (config kind, bands, max_components, clip)
SCENES = {
    "disk_4": ("fixed", 4, 64, lambda: disk_clip(128, 160, 24, 6)),
    "adversarial_4": ("bare", 4, 32, adversarial_clip),
    "otsu_4": ("otsu", 4, 64, lambda: disk_clip(128, 160, 16, 13)),
    "disk_3": ("fixed", 3, 64, lambda: disk_clip(96, 128, 16, 4)),
    "odd_2": ("fixed", 2, 64, lambda: disk_clip(90, 96, 16, 2)),
}


def run_tpuva(kind, n, C, clip, plate):
    c = cfg(jcfg, kind)
    T, H, W = clip.shape
    fn = jsp.make_spatial_processor(c, H, W, n, mesh=jsp.make_space_mesh(n), max_components=C)
    carry = jpl.init_carry(c, H, W, plate)
    outs = []
    for s in range(0, T, c.batch):
        carry, out = fn(carry, jnp.asarray(clip[s:s + c.batch]))
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return carry, outs


@pytest.fixture(scope="module")
def tpuva_runs():
    """Every scene through tpuva's spatial processor, once a module."""
    return {name: (clip_plate, run_tpuva(kind, n, C, *clip_plate))
            for name, (kind, n, C, make) in SCENES.items()
            for clip_plate in [make()]}


def run_port(kind, n, C, clip, plate, bands_in=False):
    """The scene through the port's spatial processor and its single-device
    process_batch; returns (spatial carry, spatial outs, single carry,
    single outs)."""
    c = cfg(tcfg, kind)
    T, H, W = clip.shape
    fn = make_spatial_processor(c, H, W, n, mesh=make_space_mesh(n, [CPU] * n), max_components=C)
    carry_sp = init_carry(c, H, W, plate, device="cpu")
    carry_1 = init_carry(c, H, W, plate, device="cpu")
    outs_sp, outs_1 = [], []
    for s in range(0, T, c.batch):
        chunk = torch.from_numpy(clip[s:s + c.batch])
        frames = chunk.chunk(n, dim=1) if bands_in else chunk
        carry_sp, out = fn(carry_sp, frames)
        outs_sp.append(out)
        carry_1, out_1 = process_batch(c, carry_1, chunk, max_components=C)
        outs_1.append(out_1)
    return carry_sp, outs_sp, carry_1, outs_1


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_spatial_matches_single_device_and_tpuva(scene, tpuva_runs):
    """Every batch's outputs bit-equal to the port's process_batch, the
    carried background, track table and frame index too; rows, sums,
    stats_overflow and tp_recon_rounds equal to tpuva's spatial processor,
    the background within R1's rtol."""
    kind, n, C, _make = SCENES[scene]
    (clip, plate), (carry_j, outs_j) = tpuva_runs[scene]
    carry_sp, outs_sp, carry_1, outs_1 = run_port(kind, n, C, clip, plate,
                                                  bands_in=scene == "disk_3")
    for step, (o, o1, oj) in enumerate(zip(outs_sp, outs_1, outs_j)):
        for k in OUT_KEYS:
            assert torch.equal(o[k], o1[k]), f"step {step}: {k} against process_batch"
        for k in ("rows", "row_valid", "row_sums", "stats_overflow", "tp_recon_rounds"):
            np.testing.assert_array_equal(o[k].numpy(), oj[k], err_msg=f"step {step}: {k}")
    assert sum(int(o["row_valid"].sum()) for o in outs_sp), "no detections: the scene is vacuous"
    assert isinstance(carry_sp.bg, tuple) and len(carry_sp.bg) == n
    bg = torch.cat(carry_sp.bg)
    assert torch.equal(bg, carry_1.bg)
    for f in TrackState._fields:
        assert torch.equal(getattr(carry_sp.track, f), getattr(carry_1.track, f)), f
        np.testing.assert_array_equal(getattr(carry_sp.track, f).numpy(),
                                      np.asarray(getattr(carry_j.track, f)), err_msg=f)
    assert int(carry_sp.frame_idx) == int(carry_1.frame_idx) == int(carry_j.frame_idx)
    np.testing.assert_allclose(bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)
    if scene == "adversarial_4":  # components through 2-4 bands take > 1 round
        assert all(int(o["tp_recon_rounds"]) > 1 for o in outs_sp)
        assert all(int(o["stats_overflow"].max()) == 0 for o in outs_sp)


@pytest.mark.parametrize("kind,n", [("fixed", 4), ("otsu", 4), ("fixed", 2)])
def test_band_front_end_is_the_single_device_mask(kind, n):
    """Each band's front end — its rows with the halo on its interior sides
    only, K1's plain version bordering the true image edges — gives the
    single-device mask's rows and background rows; for Otsu with the
    thresholds of the whole frames' histogram."""
    c = cfg(tcfg, kind)
    clip, plate = disk_clip(90 if n == 2 else 128, 160, 8, 11)
    T, H, W = clip.shape
    Hb, halo = H // n, _halo_rows(c)
    frames = torch.from_numpy(clip)
    carry = init_carry(c, H, W, plate, device="cpu")
    mask, bg_last = torch_front_end(c, carry, frames)
    if kind == "otsu":
        from tpuva_torch.ops.filters import otsu_threshold

        du8, _bg = _front_end_emit(c, carry, frames)
        thr = otsu_threshold(du8)
    for b in range(n):
        lo, hi = max(0, b * Hb - halo), min(H, (b + 1) * Hb + halo)
        band = carry._replace(bg=carry.bg[lo:hi])
        out, bg_b = _front_end_emit(c, band, frames[:, lo:hi])
        if kind == "otsu":
            from tpuva_torch.graph.pipeline import _otsu_mask

            out = _otsu_mask(c, out, thr)
        rows = slice(b * Hb - lo, b * Hb - lo + Hb)
        assert torch.equal(out[:, rows], mask[:, b * Hb:(b + 1) * Hb]), f"band {b}"
        assert torch.equal(bg_b[rows], bg_last[b * Hb:(b + 1) * Hb]), f"band {b}"


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_segmented_min_scan_matches_tpuva(axis, reverse):
    """tpuva's prefix doubling and the port's cummin over run-keyed int64
    give the same bits on random masks of five densities (3 frames each),
    random int32 values (their extremes included) and odd lengths."""
    rng = np.random.default_rng(10 * axis + reverse)
    densities = np.repeat([0.0, 0.2, 0.5, 0.9, 1.0], 3)[:, None, None]
    m = rng.random((15, 37, 45)) < densities
    v = rng.integers(-2**31, 2**31, m.shape, dtype=np.int64).astype(np.int32)
    v.reshape(-1)[:2] = (-2**31, 2**31 - 1)
    scan = jax.jit(j_segmented_min_scan, static_argnums=(2, 3), static_argnames=("reverse",))
    want = np.asarray(scan(jnp.asarray(v), jnp.asarray(m), axis, 7, reverse=reverse))
    got = _segmented_min_scan(torch.from_numpy(v), torch.from_numpy(m), axis, 7, reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,n,kind,match", [
    (96, 5, "fixed", "not divisible"),  # 96 % 5
    (40, 8, "fixed", "halo larger than band"),  # halo 6 > 5 rows
    (8, 8, "bare", "at least 2 rows"),  # 1-row bands, halo 1
])
def test_bad_geometry_raises_tpuva_errors(H, n, kind, match):
    """tpuva's checks, types and messages, in tpuva's order; a mesh of
    too few devices raises too, and the default mesh (the cards) has none
    here."""
    for module, make in ((jcfg, jsp.make_spatial_processor), (tcfg, make_spatial_processor)):
        mesh = (jsp.make_space_mesh(n) if module is jcfg
                else make_space_mesh(n, [CPU] * n))
        with pytest.raises(ValueError, match=match):
            make(cfg(module, kind), H, 64, n, mesh=mesh)
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_space_mesh(4, [CPU] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            make_space_mesh(2)
