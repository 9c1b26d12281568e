"""tpuva's chip checks and BASELINE configs 1-3 (tpuva_torch.scenes.
BASELINE_CASES, phase 7h of chip_smoke.py) on the CPU at a reduced size:
each case's config, on a smaller clip of its own kind, through the port's
process_clip (the torch front end, and K1's plain version with
use_pallas) and StreamingPipeline (the default route, and the staged route
process_batch_staged with force_staged), against tpuva's process_clip
(its fused Pallas front end in interpret mode) row for row, and against
the OpenCV reference (refimpl.pipeline.run_pipeline) CSV byte for CSV byte.
The small clips keep what each case exercises: a ragged last batch,
greedy association with max_blobs 4, the padded handoff with Wp - W >= 256
(128 x 1100), and shapes where it does not hold (480p-like and 4K-like:
fused_tile's rows not a multiple of 64, and a partial last strip of 256
columns, which 480p has and 4K UHD, 15 strips wide, has not)."""

import dataclasses

import numpy as np
import pytest

import refimpl.pipeline as rp
import refimpl.synthetic as synthetic
import tpuva.graph.config as jcfg
import tpuva.graph.pipeline as jp
from tpuva.ops.pallas.fused_segment import fused_tile as jax_fused_tile
from tpuva_torch.export.csvio import format_rows
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph import pipeline as tp
from tpuva_torch.graph.streaming import StreamingPipeline
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.scenes import BASELINE_CASES, baseline_case, baseline_clip
from test_torch_kernels import one_torch_thread  # noqa: F401

MAX_COMPONENTS = 32
# each case's clip at a reduced size, and its batch
SMALL = {
    "config1_480p": (dict(h=96, w=160, frames=20), 8),  # ragged 4; Hp = 96
    "config2_720p": (dict(h=128, w=1100, frames=8), 4),  # padded, Wp - W = 948
    "config3_births": (dict(h=120, w=200, frames=24, radius=8.0), 16),  # padded; ragged 8
    "otsu_480p": (dict(h=96, w=160, frames=20, radius=8.0), 8),  # ragged 4
    "uhd_4k": (dict(h=216, w=384, frames=6, radius=10.0), 4),  # Hp = 288; ragged 2
}
ROUTES = ("process_clip", "process_clip_k1", "stream", "stream_staged")


def small_case(name, config=tcfg):
    kw, batch = SMALL[name]
    case = baseline_case(name, config, **kw)
    return case._replace(cfg=dataclasses.replace(case.cfg, batch=batch))


def reference_rows(clip, cfg, plate):
    """refimpl's rows; for Otsu each frame's threshold by tpuva's float32
    rule, as chip_smoke.py's Otsu pins take it (ROADMAP Queue 3, R2)."""
    if cfg.segment.threshold != "otsu":
        return rp.run_pipeline(clip, cfg, background0=plate).rows
    import jax.numpy as jnp
    from tpuva.ops.filters import otsu_threshold

    threshold = rp.cv2.threshold

    def float32_otsu(src, thresh, maxval, kind):
        if kind & rp.cv2.THRESH_OTSU:
            thresh, kind = float(otsu_threshold(jnp.asarray(src))), kind & ~rp.cv2.THRESH_OTSU
        return threshold(src, thresh, maxval, kind)

    rp.cv2.threshold = float32_otsu
    try:
        return rp.run_pipeline(clip, cfg, background0=plate).rows
    finally:
        rp.cv2.threshold = threshold


@pytest.fixture(scope="module")
def runs():
    """{case: (clip, plate, tpuva's (rows, carry, masks), refimpl's rows)},
    made once a case."""
    cache = {}

    def get(name):
        if name not in cache:
            case = small_case(name)
            clip, plate = baseline_clip(case, synthetic)
            jax = jp.process_clip(clip, small_case(name, jcfg).cfg, background0=plate,
                                  max_components=MAX_COMPONENTS, return_masks=True,
                                  use_pallas=True)
            cache[name] = (clip, plate, jax, reference_rows(clip, case.cfg, plate))
        return cache[name]

    return get


def run_route(route, case, clip, plate):
    """(rows, carry or None, masks or None) of the port's route on the CPU."""
    if route.startswith("process_clip"):
        return tp.process_clip(clip, case.cfg, background0=plate, max_components=MAX_COMPONENTS,
                               return_masks=True, use_pallas=route.endswith("k1"),
                               device="cpu")
    staged = route == "stream_staged"
    rows = StreamingPipeline(case.cfg, max_components=MAX_COMPONENTS, use_pallas=staged,
                             force_staged=staged, device="cpu").run(VideoMemory(clip),
                                                                    background0=plate)
    return rows, None, None


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", BASELINE_CASES)
def test_case_matches_tpuva_and_opencv(runs, name, route):
    """The rows are tpuva's and the CSV bytes the OpenCV reference's; for
    process_clip the masks are tpuva's, and so is the final carry, the
    ragged batch's repeated frames included (the background within 1e-5:
    tpuva's update is FMA-contracted, R1)."""
    case = small_case(name)
    clip, plate, (rows_j, carry_j, masks_j), ref = runs(name)
    rows, carry, masks = run_route(route, case, clip, plate)
    assert rows == rows_j and len(rows) >= 8
    assert format_rows(rows) == format_rows(ref)
    if carry is not None:
        np.testing.assert_array_equal(masks, masks_j)
        for f in ("pos", "tid", "missed", "active", "next_id"):
            np.testing.assert_array_equal(getattr(carry.track, f).numpy(),
                                          np.asarray(getattr(carry_j.track, f)))
        assert int(carry.frame_idx) == int(carry_j.frame_idx) == \
            -(-clip.shape[0] // case.cfg.batch) * case.cfg.batch
        np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)


@pytest.mark.parametrize("name", BASELINE_CASES)
def test_small_cases_keep_what_the_card_runs(name):
    """Each small case keeps the trait of its full-size case that the
    card's run exercises, and the full-size facts hold: the padded handoff
    exactly where tpuva's fused_tile predicate takes it (720p and 1080p,
    not 480p or 4K), 768 columns of padding at 720p, greedy with max_blobs
    4 at 480p, a ragged last batch for config 1."""
    full, small = baseline_case(name), small_case(name)
    for case in (full, small):
        H, W = case.clip_kw["h"], case.clip_kw["w"]
        _th, _tw, Hp, Wp = jax_fused_tile(H, W)
        aligned = Hp % 64 == 0 and Wp % 256 == 0 and case.cfg.segment.threshold != "otsu"
        assert case.padded == aligned == (name in ("config2_720p", "config3_births"))
        if name == "config2_720p":
            assert Wp - W == (768 if case is full else 948)
        if name in ("config1_480p", "otsu_480p", "uhd_4k"):
            assert Hp % 64  # K2 derives the occupancy from the cropped mask
    if name in ("config1_480p", "otsu_480p", "uhd_4k"):
        # 640 leaves a partial last strip of 256 columns; 3840 is 15 whole strips
        assert full.clip_kw["w"] % 256 == (0 if name == "uhd_4k" else 128)
    greedy = name in ("config1_480p", "otsu_480p")
    for case in (full, small):
        assert (case.cfg.track.assigner == "greedy") == greedy
        assert case.cfg.segment.max_blobs == (4 if name != "config3_births" and name != "uhd_4k"
                                              else 8)
    assert full.clip_kw["frames"] % full.cfg.batch == (44 if name == "config1_480p" else 0)
    if name != "config2_720p":
        assert small.clip_kw["frames"] % small.cfg.batch
    # the case's config is the same in both packages' config modules
    assert full.cfg.to_json() == baseline_case(name, jcfg).cfg.to_json()


@pytest.mark.parametrize("name", BASELINE_CASES)
def test_staged_route_hands_k2_the_padded_mask_where_it_should(monkeypatch, runs, name):
    """process_batch_staged (StreamingPipeline with force_staged) runs K1
    with padded_occ and gives K2 its strip occupancy exactly where
    padded_handoff holds; elsewhere K2 derives it from the cropped mask."""
    case = small_case(name)
    clip, plate, _jax, ref = runs(name)
    k1, k2 = [], []
    real_k1, real_k2 = tp.fused_segment, tp.label_stats

    def spy_k1(frames, bg0, **kw):
        k1.append(kw.get("padded_occ", False))
        return real_k1(frames, bg0, **kw)

    def spy_k2(mask, C, strip_occ=None, **kw):
        k2.append((strip_occ is not None, tuple(mask.shape[1:])))
        return real_k2(mask, C, strip_occ=strip_occ, **kw)

    monkeypatch.setattr(tp, "fused_segment", spy_k1)
    monkeypatch.setattr(tp, "label_stats", spy_k2)
    rows, _c, _m = run_route("stream_staged", case, clip, plate)
    assert format_rows(rows) == format_rows(ref)
    batches = -(-clip.shape[0] // case.cfg.batch)
    H, W = clip.shape[1:]
    _th, _tw, Hp, Wp = jax_fused_tile(H, W)
    assert k1 == [case.padded] * batches
    assert k2 == [(case.padded, (Hp, Wp) if case.padded else (H, W))] * batches
