"""The port's slice end to end (tpuva_torch.graph.pipeline) against
tpuva.graph.pipeline on the CPU: same clip, same config, rows and CSV
bytes identical. Also the resume path (a JAX carry continued in the port),
and the copies the port carries of jax-free modules (config dataclasses,
CSV writer, collect_rows_array), each pinned to its original."""

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
                                      return_masks=True)
    np.testing.assert_array_equal(masks, masks_j)
    assert rows == rows_j and rows


def test_resume_from_jax_carry(clip, jax_run):
    """One batch in JAX, carry_from_numpy, the rest in the port: rows
    equal a full JAX run (the carry is the system's whole state)."""
    frames, _alive, _truth, plate = clip
    cfg = bench_cfg()
    N = cfg.batch
    carry_j = jp.init_carry(cfg, 96, 256, plate)
    carry_j, out = jp.process_batch(cfg, carry_j, jnp.asarray(frames[:N]),
                                    max_components=MAX_COMPONENTS)
    rows = jp.collect_rows(out["rows"], out["row_valid"], row_sums=out["row_sums"])
    carry = tp.carry_from_numpy(carry_j)
    back = tp.carry_to_numpy(carry)
    np.testing.assert_array_equal(back.bg, np.asarray(carry_j.bg))
    assert back.track.next_id == np.asarray(carry_j.track.next_id)
    for start in range(N, frames.shape[0], N):
        chunk = frames[start:start + N]
        n = chunk.shape[0]
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], N - n, axis=0)])
        carry, out = tp.process_batch(cfg, carry, torch.from_numpy(chunk),
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
    frames = torch.from_numpy(clip[0][:2])
    carry = tp.init_carry(bench_cfg(tcfg), 96, 256)
    otsu = dataclasses.replace(bench_cfg(tcfg), segment=tcfg.SegmentConfig(threshold="otsu"))
    with pytest.raises(NotImplementedError):
        tp.process_batch(otsu, carry, frames)
    med5 = dataclasses.replace(bench_cfg(tcfg), median=tcfg.MedianConfig(5))
    with pytest.raises(NotImplementedError):
        tp.process_batch(med5, carry, frames)
