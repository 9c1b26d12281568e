"""The port's soak (tpuva_torch.probes.soak_100k, phase 7i of
chip_smoke.py) against bench/soak_100k.py on the CPU: the renderers, the
kill-and-resume run at 96 x 128 (batch 64, 2048 frames) against the
OpenCV reference and, on its first 1024 frames, tpuva's run_soak on the
JAX CPU backend, and the oracles.

tpuva's rows differ from the port's and the reference's on 4 of the first
1024 frames' 5490 rows: XLA:CPU contracts tpuva's background update into an FMA
(ROADMAP Queue 3, R1), which moves a few pixels of a blob's mask across
the threshold. The port keeps the two roundings that refimpl pins, so its
CSV is the reference's byte for byte."""

import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

from refimpl.pipeline import run_pipeline
from tpuva_torch.export.csvio import format_rows
from tpuva_torch.ops.filters import gaussian_blur_u8
from tpuva_torch.probes import soak_100k as soak
from test_torch_kernels import one_torch_thread  # noqa: F401

H, W, BATCH, FRAMES = 96, 128, 64, 2048
JAX_FRAMES = 1024  # the frames tpuva's run_soak covers
# the frames below JAX_FRAMES whose rows tpuva's run gives otherwise (R1),
# one row each
R1_FRAMES = [469, 744, 971, 996]


@pytest.fixture(scope="module")
def bench_soak():
    spec = importlib.util.spec_from_file_location(
        "bench_soak_100k",
        os.path.join(os.path.dirname(__file__), "..", "bench", "soak_100k.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Run A (uninterrupted) and run B (killed after half its 32 batches,
    checkpointed every 5, resumed) of the port on the CPU: (rows A, RowLog
    bytes A and B, carry A, the frame B resumed from)."""
    d = tmp_path_factory.mktemp("soak")
    cfg = soak.build_cfg(BATCH)
    log_a, carry_a = soak.run_soak(cfg, H, W, FRAMES, str(d / "a.npz"), str(d / "a.rows"),
                                   device="cpu")
    with pytest.raises(soak.Abort):
        soak.run_soak(cfg, H, W, FRAMES, str(d / "b.npz"), str(d / "b.rows"),
                      abort_at_batch=16, ckpt_every=5, device="cpu")
    resumed = int(soak.load_checkpoint(str(d / "b.npz"), cfg, "cpu")[0].frame_idx)
    log_b, carry_b = soak.run_soak(cfg, H, W, FRAMES, str(d / "b.npz"), str(d / "b.rows"),
                                   resume=True, ckpt_every=5, device="cpu")
    rows = log_a.read()
    for log in (log_a, log_b):
        log.close()
    assert torch.equal(carry_a.bg, carry_b.bg)
    return rows, (d / "a.rows").read_bytes(), (d / "b.rows").read_bytes(), carry_a, resumed


@pytest.mark.parametrize("shape,t0", [((96, 128), 0), ((96, 128), 1234), ((96, 128), 65_536),
                                      ((96, 128), 99_999), ((96, 128), 100_344),
                                      ((1080, 1920), 100_344)])
def test_render_torch_matches_numpy_and_jax(bench_soak, shape, t0):
    """make_render_torch (on the CPU) gives the bytes of the copied
    render_frames_np and of bench/soak_100k.py's numpy and JAX renderers,
    and a region of render_frames_np is the same window of its frames."""
    import jax.numpy as jnp

    h, w = shape
    n = 8 if h < 1080 else 2
    got = soak.make_render_torch(h, w, n, "cpu")(t0).numpy()
    assert got.shape == (n, h, w) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, soak.render_frames_np(h, w, t0, n))
    np.testing.assert_array_equal(got, bench_soak.render_frames_np(h, w, t0, n))
    np.testing.assert_array_equal(got, np.asarray(bench_soak.make_render_jax(h, w, n)(
        jnp.int32(t0))))
    region = (h // 3 - 4, w // 3 - 4, 40, 56)
    np.testing.assert_array_equal(
        soak.render_frames_np(h, w, t0, n, region=region),
        got[:, region[0]:region[0] + 40, region[1]:region[1] + 56])
    assert (got > soak.AMP).any()  # a disk is drawn (the plate stays below 63)


def test_run_soak_resumes_byte_identical_and_matches_opencv_and_tpuva(bench_soak, port_run,
                                                                       tmp_path):
    """The killed-and-resumed run's RowLog is the uninterrupted run's byte
    for byte (resumed from frame 960, the checkpoint before the kill, its
    log truncated there); the rows' CSV is the OpenCV reference's on the
    same 2048 frames (background seeded from the first filtered frame on
    both sides); tpuva's run_soak (JAX CPU backend) on the first
    JAX_FRAMES frames gives the port's rows of those frames but on the R1
    frames (rows are causal)."""
    rows, bytes_a, bytes_b, _carry, resumed = port_run
    assert bytes_a == bytes_b and resumed == 15 * BATCH
    assert len(rows) == 10_924
    ref = run_pipeline(soak.render_frames_np(H, W, 0, FRAMES), soak.build_cfg(BATCH),
                       background0=None)
    assert format_rows(rows) == format_rows(ref.rows)
    log_j, _carry_j = bench_soak.run_soak(bench_soak.build_cfg(BATCH), H, W, JAX_FRAMES,
                                          str(tmp_path / "j.npz"), str(tmp_path / "j.rows"))
    rows_j = log_j.read()
    rows = rows[rows[:, 1] < JAX_FRAMES]
    assert rows_j.shape == rows.shape == (5490, 5)
    off = (rows_j != rows).any(axis=1)
    assert sorted(rows[off, 1].astype(int).tolist()) == R1_FRAMES
    assert (rows_j[:, :2] == rows[:, :2]).all()  # the same tracks at the same frames


def test_centroid_oracle_is_below_a_pixel(tmp_path):
    """The port's rows lie within 1 px (median) of the scene's analytic
    blob centres at 240 x 320 (at 96 x 128 the six disks cover so much of
    the frame that the background absorbs them: crescents ~10 px off), and
    the oracle is bench/soak_100k.py's."""
    cfg = soak.build_cfg(BATCH)
    log, _carry = soak.run_soak(cfg, 240, 320, 128, str(tmp_path / "c.npz"),
                                str(tmp_path / "c.rows"), device="cpu")
    rows = log.read()
    log.close()
    assert len(rows) > 400
    assert soak.centroid_oracle_err(rows, 240, 320) < 1.0


def test_oracles_match_the_jax_files(bench_soak, port_run):
    """centroid_oracle_err is the JAX file's on the run's rows, and the
    drift of the float32 background against the float64 recurrence (with
    gaussian_blur_u8 for cv2's blur) on a 32 x 32 crop is small."""
    rows, _a, _b, carry, _r = port_run
    assert soak.centroid_oracle_err(rows, H, W) == bench_soak.centroid_oracle_err(rows, H, W)
    drift = soak.drift_oracle(soak.build_cfg(BATCH), H, W, FRAMES, carry.bg, crop=32)
    assert 0 < drift < 1e-2


@pytest.mark.parametrize("shape", [(96, 128), (1080, 1920)])
def test_drift_oracle_blur_is_opencvs(shape):
    """drift_oracle blurs its margin-padded crop with the port's
    gaussian_blur_u8 in place of the JAX file's cv2.GaussianBlur: on
    frames where a disk crosses the crop, that gives cv2's blur of the
    whole frame cropped, byte for byte."""
    h, w = shape
    crop, m = 32 if h < 1080 else 64, 4
    y0, x0 = h // 3, w // 3
    region = (y0 - m, x0 - m, crop + 2 * m, crop + 2 * m)
    hits = [t for t in range(0, 100_000, 37)
            if (soak.render_frames_np(h, w, t, 1, region=region) > soak.AMP).any()][:3]
    assert len(hits) == 3
    for t in hits:
        got = gaussian_blur_u8(torch.from_numpy(soak.render_frames_np(h, w, t, 1, region=region)),
                               5, 0.0)[0, m:-m, m:-m].numpy()
        want = cv2.GaussianBlur(soak.render_frames_np(h, w, t, 1)[0], (5, 5), 0.0)
        np.testing.assert_array_equal(got, want[y0:y0 + crop, x0:x0 + crop])
