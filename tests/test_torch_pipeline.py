"""The port's pipeline (tpuva_torch.graph.pipeline) against
tpuva.graph.pipeline on the CPU: same clip, same config, rows and CSV
bytes identical, through the one-dispatch process_batch (torch front end
or K1's plain version, with a sequential or scanned background; K3's plain
version) and the staged process_batch_staged (K1 + K2 plain). Also the
resume path (a JAX carry continued in the port), and the copies the port
carries of jax-free modules (config dataclasses, CSV writer,
collect_rows_array), each pinned to its original."""

import dataclasses
import io

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuva.graph.config as jcfg
import tpuva.graph.pipeline as jp
from refimpl.synthetic import multi_blob_clip
from tpuva.export.csvio import format_rows as jax_format_rows
from tpuva_torch.export.csvio import format_rows, write_tracks_csv
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph import pipeline as tp
from tpuva_torch.graph.streaming import StreamingPipeline
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.scenes import K1_REFUSED, k1_refused_config
from test_torch_kernels import one_torch_thread  # noqa: F401

MAX_COMPONENTS = 32


def bench_cfg(module=jcfg, assigner="hungarian", batch=16):
    """bench.py's config (blur 5, alpha 0.02, threshold 35,
    open 3 rect, close 3 ellipse, min_area 50, max_blobs 8, 16 tracks)."""
    return module.PipelineConfig(
        background=module.BackgroundConfig(alpha=0.02),
        blur=module.BlurConfig(ksize=5, sigma=0.0),
        morph_open=module.MorphConfig(ksize=3, shape="rect"),
        morph_close=module.MorphConfig(ksize=3, shape="ellipse"),
        segment=module.SegmentConfig(threshold=35.0, min_area=50, max_blobs=8),
        track=module.TrackConfig(max_dist=80.0, death_patience=5, max_tracks=16,
                                 assigner=assigner),
        batch=batch,
    )


@pytest.fixture(scope="module")
def clip():
    return multi_blob_clip(96, 256, 40, n_blobs=4, radius=8.0,
                           births_deaths=True, noise_sigma=2.0, seed=5)


@pytest.fixture(scope="module")
def jax_run(clip):
    frames, _alive, _truth, plate = clip
    return jp.process_clip(frames, bench_cfg(), background0=plate,
                           max_components=MAX_COMPONENTS, return_masks=True)


@pytest.mark.parametrize("cfg_module", [jcfg, tcfg], ids=["tpuva_cfg", "port_cfg"])
def test_process_clip_matches_tpuva(clip, jax_run, cfg_module):
    frames, _alive, _truth, plate = clip
    rows_j, carry_j, masks_j = jax_run
    rows, carry, masks = tp.process_clip(
        frames, bench_cfg(cfg_module), background0=plate,
        max_components=MAX_COMPONENTS, return_masks=True, device="cpu",
    )
    np.testing.assert_array_equal(masks, masks_j)
    assert rows == rows_j and len(rows) > 60
    assert format_rows(rows) == jax_format_rows(rows_j)
    np.testing.assert_array_equal(
        np.asarray(rows, np.float64), np.asarray(rows_j, np.float64)
    )
    for f in ("pos", "tid", "missed", "active", "next_id"):
        np.testing.assert_array_equal(
            getattr(carry.track, f).numpy(), np.asarray(getattr(carry_j.track, f))
        )
    assert int(carry.frame_idx) == int(carry_j.frame_idx) == 48
    # XLA:CPU fuses the reference's background update into an FMA (see
    # tests/test_torch_fused_segment.py); the port keeps the two roundings
    np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)


def test_seeded_background_matches_tpuva(clip):
    """No plate: both seed the background from the filtered first frame
    (same compiled JAX program as above: bg_valid is data, not static)."""
    frames = clip[0][:24]
    rows_j, _c, masks_j = jp.process_clip(frames, bench_cfg(), max_components=MAX_COMPONENTS,
                                          return_masks=True)
    rows, _c, masks = tp.process_clip(frames, bench_cfg(), max_components=MAX_COMPONENTS,
                                      return_masks=True, device="cpu")
    np.testing.assert_array_equal(masks, masks_j)
    assert rows == rows_j and rows


def test_resume_from_jax_carry(clip, jax_run):
    """One batch in JAX, carry_from_numpy, the rest in the port's staged
    route: rows equal a full JAX run (the carry is the system's whole
    state)."""
    frames, _alive, _truth, plate = clip
    cfg = bench_cfg()
    N = cfg.batch
    carry_j = jp.init_carry(cfg, 96, 256, plate)
    carry_j, out = jp.process_batch(cfg, carry_j, jnp.asarray(frames[:N]),
                                    max_components=MAX_COMPONENTS)
    rows = jp.collect_rows(out["rows"], out["row_valid"], row_sums=out["row_sums"])
    carry = tp.carry_from_numpy(carry_j, device="cpu")
    back = tp.carry_to_numpy(carry)
    np.testing.assert_array_equal(back.bg, np.asarray(carry_j.bg))
    assert back.track.next_id == np.asarray(carry_j.track.next_id)
    for start in range(N, frames.shape[0], N):
        chunk = frames[start:start + N]
        n = chunk.shape[0]
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], N - n, axis=0)])
        carry, out = tp.process_batch_staged(cfg, carry, torch.from_numpy(chunk),
                                             max_components=MAX_COMPONENTS)
        rows += tp.collect_rows(out["rows"].numpy(), out["row_valid"].numpy(),
                                max_frame=frames.shape[0],
                                row_sums=out["row_sums"].numpy())
    assert rows == jax_run[0]


def test_collect_rows_array_matches_original():
    rng = np.random.default_rng(0)
    rows = rng.uniform(0, 100, (6, 4, 5)).astype(np.float32)
    rows[..., 1] = np.arange(6)[:, None]
    rows[..., 4] = rng.integers(1, 500, (6, 4))
    valid = rng.random((6, 4)) < 0.6
    sums = rng.integers(0, 1 << 20, (6, 4, 2)).astype(np.int32)
    for mf in (None, 4):
        for s in (None, sums):
            np.testing.assert_array_equal(
                tp.collect_rows_array(rows, valid, mf, s),
                jp.collect_rows_array(rows, valid, mf, s),
            )


def test_config_copy_matches_original():
    for a, b in ((tcfg.PipelineConfig, jcfg.PipelineConfig),
                 (tcfg.BlurConfig, jcfg.BlurConfig),
                 (tcfg.MedianConfig, jcfg.MedianConfig),
                 (tcfg.MorphConfig, jcfg.MorphConfig),
                 (tcfg.BackgroundConfig, jcfg.BackgroundConfig),
                 (tcfg.SegmentConfig, jcfg.SegmentConfig),
                 (tcfg.TrackConfig, jcfg.TrackConfig)):
        fa = [(f.name, f.default) for f in dataclasses.fields(a)]
        fb = [(f.name, f.default) for f in dataclasses.fields(b)]
        assert fa == fb, a.__name__
        assert a().__dict__.keys() == b().__dict__.keys()
    for med in (None, 3):
        j = bench_cfg(jcfg)
        t = bench_cfg(tcfg)
        if med:
            j = dataclasses.replace(j, median=jcfg.MedianConfig(med))
            t = dataclasses.replace(t, median=tcfg.MedianConfig(med))
        assert t.to_json() == j.to_json()
        assert tcfg.PipelineConfig.from_json(j.to_json()) == t


def test_csv_writer_copy_matches_original(tmp_path):
    rows = [(2, 5, 10.12345, 3.5, 51.0), (1, 7, 0.0005, 1919.9995, 200.0),
            (1, 3, 4.25, 6.75, 60.4)]
    assert format_rows(rows) == jax_format_rows(rows)
    write_tracks_csv(tmp_path / "t.csv", rows)
    assert (tmp_path / "t.csv").read_text() == jax_format_rows(rows)
    assert format_rows([]) == jax_format_rows([]) == io.StringIO("track_id,frame,x,y,area\n").read()


def test_not_yet_ported_options_raise(clip):
    """Median k > 3 was the one option left unported. It now runs on the
    one-dispatch route (masks and rows equal tpuva's), and only the staged
    route refuses it, as tpuva's staged route does."""
    frames = clip[0][:2]
    med5 = dataclasses.replace(bench_cfg(tcfg), median=tcfg.MedianConfig(5))
    med5_j = dataclasses.replace(bench_cfg(), median=jcfg.MedianConfig(5))
    _c, out = tp.process_batch(med5, tp.init_carry(med5, 96, 256, device="cpu"),
                               torch.from_numpy(frames), return_masks=True,
                               max_components=MAX_COMPONENTS)
    _cj, out_j = jp.process_batch(med5_j, jp.init_carry(med5_j, 96, 256), jnp.asarray(frames),
                                  return_masks=True, max_components=MAX_COMPONENTS)
    for k in ("masks", "rows", "row_valid", "row_sums"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(out_j[k]), err_msg=k)
    with pytest.raises(NotImplementedError):
        tp.process_batch_staged(med5, tp.init_carry(med5, 96, 256, device="cpu"),
                                torch.from_numpy(frames))
    with pytest.raises(AssertionError):
        jp.process_batch_staged(med5_j, jp.init_carry(med5_j, 96, 256), jnp.asarray(frames))


def f1_cfg(name, module=tcfg, batch=8):
    """The bench config changed so that one launch of kernel K1 does not
    take it."""
    return k1_refused_config(bench_cfg(module, batch=batch), name, module)


F1_NAMES = list(K1_REFUSED)
# the F1 configs fused_segment takes by splitting K1 (median 0 or 3), and
# the stages it takes out of K1's launch for each (k1_split)
F1_SPLITS = {"open_close_7x10": (False, True), "median3_5x10": (False, True),
             "se33": (False, True), "blur65": (True, False)}


def test_k1_takes():
    """The predicate one K1 launch is decided on: true for the bench config
    (both emits) and the kernel's limits, false past them; it agrees with
    the launch plan wherever that has a tile to offer, for every tap count,
    median and morphology reach. The routes take K1 wherever tpuva takes its
    Pallas K1 (_can_stage, _can_fuse), and k1_split says which stages leave
    the launch."""
    from tpuva_torch.ops.fused_segment import MAX_SE, fused_segment_plan, k1_split, k1_takes

    otsu = dataclasses.replace(bench_cfg(tcfg), segment=tcfg.SegmentConfig(threshold="otsu"))
    assert k1_takes(1080, 1920, **tp._front_end_kwargs(bench_cfg(tcfg)))
    assert k1_takes(1080, 1920, **tp._diff_kwargs(otsu))
    assert k1_takes(1080, 1920, **dict(tp._front_end_kwargs(bench_cfg(tcfg)), open_ksize=MAX_SE))
    assert k1_takes(1080, 1920, blur_ksize=63, blur_sigma=4.0, median_ksize=3)
    assert not k1_takes(1080, 1920, blur_ksize=65)
    for name in F1_NAMES:
        for H, W in ((1080, 1920), (64, 96)):
            assert not k1_takes(H, W, **tp._front_end_kwargs(f1_cfg(name))), name
            if name in F1_SPLITS:
                assert k1_split(H, W, **tp._front_end_kwargs(f1_cfg(name))) == F1_SPLITS[name]
        assert tp._can_stage(f1_cfg(name)) == jp._can_stage(f1_cfg(name, jcfg)) == (
            name in F1_SPLITS)
        assert tp._can_fuse(f1_cfg(name)) == jp._can_fuse(f1_cfg(name, jcfg))
    for blur in (0, 3, 5, 9, 31, 63):
        for median in (0, 3):
            for k, iters in ((0, 1), (3, 1), (5, 4), (7, 6), (9, 10), (15, 4)):
                kw = dict(blur_ksize=blur, median_ksize=median, open_ksize=k, open_iters=iters,
                          close_ksize=k, close_iters=iters)
                try:
                    fused_segment_plan(1080, 1920, **kw)
                    planned = True
                except ValueError:
                    planned = False
                assert k1_takes(1080, 1920, **kw) == planned, kw


def _staged_rows(cfg, frames, plate):
    """process_batch_staged batch by batch over a clip whose length is a
    multiple of the batch."""
    T, H, W = frames.shape
    carry = tp.init_carry(cfg, H, W, plate, device="cpu")
    rows = []
    for start in range(0, T, cfg.batch):
        carry, out = tp.process_batch_staged(cfg, carry, torch.from_numpy(frames[start:start + cfg.batch]),
                                             max_components=MAX_COMPONENTS)
        rows += tp.collect_rows(out["rows"].numpy(), out["row_valid"].numpy(),
                                row_sums=out["row_sums"].numpy())
    return rows


@pytest.mark.parametrize("name", F1_NAMES)
def test_configs_k1_refuses_match_tpuva(monkeypatch, name):
    """Configs one K1 launch does not take, through process_clip on both
    values of use_pallas (both reach process_batch on the CPU) and through
    process_batch_staged, with tpuva's masks and rows (tpuva runs them
    through its jnp front end). Those with a median 0 or 3 take the K1
    wrapper, here made to run the card's split on the CPU (run_split with
    k1_split's parts: blur_u8, K1's plain version on the stages that stay,
    open_close_u8); a median k > 3 takes the median route (blur_u8 and
    median_u8, then the wrapper once a batch with no blur and no median,
    which one launch takes whole). median5 starts without a plate (the
    background seeded from the filtered first frame). Both staged routes
    refuse a median k > 3."""
    from tpuva_torch.ops import fused_segment as fs

    # blobs wide enough to survive an open that erodes 30 px deep
    frames, _alive, _truth, plate = multi_blob_clip(160, 240, 16, n_blobs=2, radius=46.0,
                                                    noise_sigma=2.0, seed=7)
    if name == "median5":
        plate = None
    rows_j, carry_j, masks_j = jp.process_clip(frames, f1_cfg(name, jcfg), background0=plate,
                                               max_components=MAX_COMPONENTS, return_masks=True)
    assert len(rows_j) > 10

    calls = []

    def split_k1(frames, bg0, **kw):
        parts = fs.k1_split(*frames.shape[1:], **kw)
        calls.append(parts)
        kw = dict(dict(blur_ksize=0, blur_sigma=0.0, median_ksize=0, open_shape="rect",
                       open_ksize=0, open_iters=1, close_shape="rect", close_ksize=0,
                       close_iters=1, seed_bg=False), **kw)
        return fs.run_split(frames, bg0, parts, fs.fused_segment_plain, **kw)

    monkeypatch.setattr(tp, "fused_segment", split_k1)
    for use_pallas in (False, True):
        rows, carry, masks = tp.process_clip(frames, f1_cfg(name), background0=plate,
                                             max_components=MAX_COMPONENTS, return_masks=True,
                                             use_pallas=use_pallas, device="cpu")
        np.testing.assert_array_equal(masks, masks_j)
        assert rows == rows_j
        np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)
    if f1_cfg(name).median is not None and f1_cfg(name).median.ksize > 3:
        with pytest.raises(NotImplementedError):
            _staged_rows(f1_cfg(name), frames, plate)
    else:
        assert _staged_rows(f1_cfg(name), frames, plate) == rows_j
    assert set(calls) == ({F1_SPLITS[name]} if name in F1_SPLITS else {(False, False)})


@pytest.mark.parametrize("route", ["default", "staged"])
def test_ccl_single_pass_rows_match_tpuva(clip, jax_run, route):
    """ccl_single_pass maps onto K2: the rows of tpuva's single-pass
    process_clip (its single-pass Pallas CCL and reconcile, interpret
    mode), on the one-dispatch route (process_batch takes K2 for its
    stats) and on the staged one (StreamingPipeline, force_staged)."""
    frames, _alive, _truth, plate = clip
    rows_j, _c, _m = jp.process_clip(frames, bench_cfg(), background0=plate,
                                     max_components=MAX_COMPONENTS, ccl_single_pass=True)
    if route == "default":
        rows, _c, _m = tp.process_clip(frames, bench_cfg(), background0=plate,
                                       max_components=MAX_COMPONENTS, ccl_single_pass=True,
                                       device="cpu")
    else:
        rows = StreamingPipeline(bench_cfg(), max_components=MAX_COMPONENTS, use_pallas=True,
                                 force_staged=True, ccl_single_pass=True, device="cpu").run(
            VideoMemory(frames), background0=plate)
    assert rows == rows_j == jax_run[0]


def blob_scene(N=2, H=64, W=96, n=10, seed=8):
    """N frames of n small disks: more components than max_components."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    frames = np.full((N, H, W), 20, np.uint8)
    for t in range(N):
        for _ in range(n):
            cy, cx, r = rng.integers(4, H - 4), rng.integers(4, W - 4), rng.integers(2, 4)
            frames[t][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 200
    return frames


def test_return_labels_matches_tpuva():
    """out["labels"] of process_batch_staged against tpuva's
    labels_from_raw (interpret mode) with max_components=4 on ~10 blobs a
    frame: ids 1..4 for the first four components, 0 for the rest; and
    tpuva's warning when ccl_single_pass comes with it."""
    frames = blob_scene()
    cfg = dataclasses.replace(bench_cfg(), blur=None, morph_open=None, morph_close=None,
                              segment=jcfg.SegmentConfig(50.0, 1, 4), batch=2)
    plate = np.full((64, 96), 20, np.float32)
    _c, out_j = jp.process_batch_staged(cfg, jp.init_carry(cfg, 64, 96, plate),
                                        jnp.asarray(frames), max_components=4,
                                        return_labels=True)
    _c, out = tp.process_batch_staged(cfg, tp.init_carry(cfg, 64, 96, plate, device="cpu"),
                                      torch.from_numpy(frames), max_components=4,
                                      return_labels=True)
    labels = out["labels"].numpy()
    np.testing.assert_array_equal(labels, np.asarray(out_j["labels"]))
    assert labels.dtype == np.int32 and labels.max() == 4
    assert ((frames > 100) & (labels == 0)).any()  # later components are 0
    with pytest.warns(UserWarning, match="ccl_single_pass is ignored"):
        tp.process_batch_staged(cfg, tp.init_carry(cfg, 64, 96, plate, device="cpu"),
                                torch.from_numpy(frames), max_components=4,
                                return_labels=True, ccl_single_pass=True)


@pytest.mark.parametrize("parallel_bg", [False, True], ids=["seq_bg", "parallel_bg"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["torch_front", "k1_front"])
def test_process_batch_matches_tpuva(clip, use_pallas, parallel_bg):
    """tpuva's process_batch (its jnp front end, or the Pallas K1 in
    interpret mode) against the port's, batch by batch from the same
    carry: masks and rows equal.

    Background tolerance: rtol 1e-5 (XLA:CPU contracts tpuva's update
    into an FMA, see above). The scanned background (parallel_bg, the
    torch front end only; tpuva ignores it under use_pallas) takes the
    same combination tree as jax.lax.associative_scan, but XLA may
    contract its s2 * o1 + o2 as well; measured on this clip: max
    relative difference 2.45e-7 over the three batches (the sequential
    form: 1.66e-6), so rtol 1e-6 holds it."""
    frames, _alive, _truth, plate = clip
    cfg = bench_cfg(tcfg)
    N = cfg.batch
    carry_j = jp.init_carry(bench_cfg(), 96, 256, plate)
    carry = tp.init_carry(cfg, 96, 256, plate, device="cpu")
    rtol = 1e-6 if parallel_bg and not use_pallas else 1e-5
    for start in range(0, 48, N):
        chunk = frames[start:start + N]
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], N - len(chunk), axis=0)])
        carry_j, out_j = jp.process_batch(
            bench_cfg(), carry_j, jnp.asarray(chunk), parallel_bg=parallel_bg,
            return_masks=True, max_components=MAX_COMPONENTS, use_pallas=use_pallas)
        carry, out = tp.process_batch(
            cfg, carry, torch.from_numpy(chunk), parallel_bg=parallel_bg,
            return_masks=True, max_components=MAX_COMPONENTS, use_pallas=use_pallas)
        np.testing.assert_array_equal(out["masks"].numpy(), np.asarray(out_j["masks"]))
        for k in ("rows", "row_valid", "row_sums", "n_det", "active_tracks"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(out_j[k]), err_msg=k)
        np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=rtol)
        assert out["ccl_converged"] is True and not out["stats_overflow"].any()
    assert int(out["n_det"].sum()) > 0


def test_background_trajectory_parallel_matches_sequential():
    """The scanned trajectory against the port's own sequential one on
    random float32 frames, N in {1, 2, 7, 16} (odd and even recursion
    steps). Tolerance rtol 1e-5: the scan multiplies (1 - a) up to N times
    before applying it, a few float32 roundings of relative size 6e-8."""
    rng = np.random.default_rng(2)
    for n in (1, 2, 7, 16):
        f = torch.from_numpy(rng.uniform(0, 255, (n, 5, 7)).astype(np.float32))
        bg0 = torch.from_numpy(rng.uniform(0, 255, (5, 7)).astype(np.float32))
        seq = tp.background_trajectory(bg0, f, 0.02)
        par = tp.background_trajectory(bg0, f, 0.02, parallel=True)
        assert par.shape == seq.shape == (n, 5, 7)
        np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=1e-5)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the entry points raise unless given device="cpu"."""
    from tpuva_torch.track.table import init_track_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = bench_cfg(tcfg)
    plate = np.zeros((8, 8), np.float32)
    for call in (lambda: tp.init_carry(cfg, 8, 8),
                 lambda: tp.carry_from_numpy(tp.init_carry(cfg, 8, 8, plate, device="cpu")),
                 lambda: tp.process_clip(np.zeros((2, 8, 8), np.uint8), cfg),
                 lambda: init_track_state(4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("threshold", [35.0, "otsu"], ids=["mask", "otsu_diff"])
def test_sequential_front_end_goes_through_fused_segment(monkeypatch, threshold):
    """process_batch(parallel_bg=False) takes its front end from the K1
    wrapper (which launches the kernel on a card) for both emits, and
    reaches the plain version only through that wrapper."""
    import tpuva_torch.ops.fused_segment as fs

    calls = {"wrapper": [], "plain": 0}
    real_wrapper, real_plain = tp.fused_segment, fs.fused_segment_plain

    def wrapper(*args, **kw):
        calls["wrapper"].append(kw["emit"])
        return real_wrapper(*args, **kw)

    def plain(*args, **kw):
        calls["plain"] += 1
        return real_plain(*args, **kw)

    monkeypatch.setattr(tp, "fused_segment", wrapper)
    monkeypatch.setattr(fs, "fused_segment_plain", plain)
    assert not hasattr(tp, "fused_segment_plain")
    frames, _alive, _truth, plate = multi_blob_clip(48, 64, 8, n_blobs=2, radius=5.0, seed=1)
    cfg = dataclasses.replace(
        bench_cfg(tcfg, batch=8),
        segment=tcfg.SegmentConfig(threshold=threshold, min_area=10, max_blobs=8))
    carry = tp.init_carry(cfg, 48, 64, plate, device="cpu")
    _carry, out = tp.process_batch(cfg, carry, torch.from_numpy(frames),
                                   max_components=MAX_COMPONENTS)
    assert calls == {"wrapper": ["diff" if threshold == "otsu" else "mask"], "plain": 1}
    assert out["rows"].shape[0] == 8


def _staged_batches(run, frames, N, carry):
    """run(carry, batch) over a clip in batches of N, the last padded by
    repeating its last frame (process_clip's rule): (rows, carry, outs)."""
    T = frames.shape[0]
    rows, outs = [], []
    for start in range(0, T, N):
        chunk = frames[start:start + N]
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], N - len(chunk), axis=0)])
        carry, out = run(carry, chunk)
        rows += tp.collect_rows(np.asarray(out["rows"]), np.asarray(out["row_valid"]),
                                max_frame=T, row_sums=np.asarray(out["row_sums"]))
        outs.append(out)
    return rows, carry, outs


# (H, W, config name): fused_tile's grid aligns to 64 x 256 at 120 x 200 and
# 160 x 240 (the padded handoff), not at 96 x 300; open_close_7x10 is a
# K1_REFUSED config whose open and close leave K1 for K1m steps
HANDOFF_CASES = {"aligned_120x200": (120, 200, None), "unaligned_96x300": (96, 300, None),
                 "split_open_close_7x10_160x240": (160, 240, "open_close_7x10")}


@pytest.mark.parametrize("name", sorted(HANDOFF_CASES))
def test_staged_padded_handoff_matches_tpuva(monkeypatch, name):
    """process_batch_staged takes K1's padded mask and occupancy exactly
    where tpuva's staged route does (padded_handoff, tpuva's fused_tile
    predicate), and gives tpuva's rows and masks, the background within
    1e-5 (R1): on the aligned shape against tpuva's staged route (Pallas,
    interpret mode, one batch) on the moving-disk scene of
    tests/test_pallas_fused.py; elsewhere against tpuva's jnp process_batch,
    which tpuva's own tests hold equal to its staged route (its Pallas
    kernels in interpret mode take most of a minute a batch here); the
    split config with fused_segment replaced by the card's split form
    run_split on the plain versions."""
    from refimpl.synthetic import moving_disk_clip
    from tpuva.ops.pallas.fused_segment import fused_tile as jax_fused_tile
    from tpuva_torch.ops import fused_segment as fs

    H, W, f1 = HANDOFF_CASES[name]
    if f1 is None:
        frames, _, plate = moving_disk_clip(h=H, w=W, frames=16, radius=8, noise_sigma=2.0,
                                            seed=21)
        cfgs = [dataclasses.replace(bench_cfg(m, batch=8), morph_close=None,
                                    background=m.BackgroundConfig(alpha=0.05),
                                    segment=m.SegmentConfig(35.0, 20, 4))
                for m in (jcfg, tcfg)]
        if name == "aligned_120x200":
            frames = frames[8:]
            jax_step = jp.process_batch_staged
        else:
            jax_step = jp.process_batch
    else:
        frames, _alive, _truth, plate = multi_blob_clip(H, W, 16, n_blobs=2, radius=46.0,
                                                        noise_sigma=2.0, seed=7)
        cfgs = [f1_cfg(f1, jcfg), f1_cfg(f1)]
        jax_step = jp.process_batch
    _th, _tw, Hp, Wp = jax_fused_tile(H, W)
    aligned = Hp % 64 == 0 and Wp % 256 == 0
    assert tp.padded_handoff(cfgs[1], H, W) == aligned == (name != "unaligned_96x300")
    calls = []
    real = tp.fused_segment

    def spy(frames, bg0, **kw):
        calls.append(kw.get("padded_occ", False))
        if f1 is None:
            return real(frames, bg0, **kw)
        parts = fs.k1_split(*frames.shape[1:], **kw)
        return fs.run_split(frames, bg0, parts, fs.fused_segment_plain, **kw)

    monkeypatch.setattr(tp, "fused_segment", spy)
    rows_j, carry_j, outs_j = _staged_batches(
        lambda c, b: jax_step(cfgs[0], c, jnp.asarray(b), return_masks=True,
                              max_components=MAX_COMPONENTS),
        frames, 8, jp.init_carry(cfgs[0], H, W, plate))
    rows, carry, outs = _staged_batches(
        lambda c, b: tp.process_batch_staged(cfgs[1], c, torch.from_numpy(b), return_masks=True,
                                             max_components=MAX_COMPONENTS),
        frames, 8, tp.init_carry(cfgs[1], H, W, plate, device="cpu"))
    assert calls == [aligned] * len(outs)
    assert rows == rows_j and len(rows) >= 8
    for o, o_j in zip(outs, outs_j):
        assert o["masks"].shape == (8, H, W)
        np.testing.assert_array_equal(o["masks"].numpy(), np.asarray(o_j["masks"]))
        assert not o["stats_overflow"].any()
    np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)


def test_padded_handoff_where_tpuva_takes_it():
    """The branch, over a grid of shapes and both thresholds: fused_tile's
    grid aligned to 64 x 256 and a fixed threshold, as tpuva's staged
    route decides (Otsu takes the cropped mask there)."""
    from tpuva.ops.pallas.fused_segment import fused_tile as jax_fused_tile

    otsu = dataclasses.replace(bench_cfg(tcfg), segment=tcfg.SegmentConfig(threshold="otsu"))
    for H in (8, 64, 96, 120, 128, 129, 160, 250, 1080, 2160):
        for W in (8, 200, 256, 300, 1000, 1024, 1025, 1920, 3840):
            _th, _tw, Hp, Wp = jax_fused_tile(H, W)
            assert tp.padded_handoff(bench_cfg(tcfg), H, W) == (Hp % 64 == 0 and Wp % 256 == 0)
            assert not tp.padded_handoff(otsu, H, W)


def test_capacity_keywords_pass_through(clip, jax_run):
    """tpuva's sparse_strips / compact_slots, with small values, through
    every entry point that takes them (process_batch, process_batch_staged,
    StreamingPipeline on both routes): K2 has no capacity, so the rows are
    tpuva's and stats_overflow stays zero."""
    frames, _alive, _truth, plate = clip
    cfg = bench_cfg(tcfg)
    knobs = dict(sparse_strips=4, compact_slots=2)
    for run in (lambda c, b: tp.process_batch(cfg, c, torch.from_numpy(b),
                                              max_components=MAX_COMPONENTS, compact_slots=2),
                lambda c, b: tp.process_batch_staged(cfg, c, torch.from_numpy(b),
                                                     max_components=MAX_COMPONENTS, **knobs)):
        rows, _c, outs = _staged_batches(run, frames, cfg.batch,
                                         tp.init_carry(cfg, 96, 256, plate, device="cpu"))
        assert rows == jax_run[0]
        assert not any(o["stats_overflow"].any() for o in outs)
    for use_pallas in (False, True):
        rows = StreamingPipeline(cfg, max_components=MAX_COMPONENTS, use_pallas=use_pallas,
                                 force_staged=use_pallas, device="cpu", **knobs).run(
            VideoMemory(frames), background0=plate)
        assert rows == jax_run[0]
