"""The port's streamed route (tpuva_torch.graph.streaming) on the CPU,
mirroring the jax-free contracts of tests/test_streaming.py, and held
against tpuva's StreamingPipeline: rows are compared exactly (==), since
the port's rows equal tpuva's bit for bit on this path (integer centroid
sums, the same float64 division on the host).

Also: checkpoints cross packages in both directions (a tpuva-written
checkpoint resumes in the port and a port-written one in tpuva, each
giving the rows of an uninterrupted JAX run), BatchStager on the CPU, and
the port's copies of VideoBase/VideoSlice/VideoMemory and BatchLogger
pinned to their originals.
"""

import dataclasses
import inspect
import io
import json
import warnings

import numpy as np
import pytest
import torch

import tpuva.graph.streaming as js
import tpuva.io.base as jio_base
import tpuva.io.memory as jio_memory
import tpuva.utils as jutils
from refimpl.synthetic import moving_disk_clip
from tpuva.graph.config import BackgroundConfig, PipelineConfig, SegmentConfig, TrackConfig
from tpuva_torch import utils as tutils
from tpuva_torch.graph.pipeline import process_clip
from tpuva_torch.graph.streaming import (
    AsyncRowDrainer,
    RowLog,
    StreamingPipeline,
    load_checkpoint,
    save_checkpoint,
)
from tpuva_torch.io import base as tio_base
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.io.staging import BatchStager
from test_torch_kernels import one_torch_thread  # noqa: F401

CFG = PipelineConfig(
    background=BackgroundConfig(alpha=0.03),
    segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
    track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
    batch=8,
)
CPU = dict(device="cpu")


def clip_and_plate(frames=64):
    clip, _, plate = moving_disk_clip(h=96, w=128, frames=frames, radius=8, seed=11)
    return clip, plate


def as_tuples(rows):
    return [(int(r[0]), int(r[1]), float(r[2]), float(r[3]), float(r[4])) for r in rows]


@pytest.fixture(scope="module")
def jax_full():
    """tpuva's uninterrupted streamed run on the 64-frame clip."""
    clip, plate = clip_and_plate()
    return js.StreamingPipeline(CFG).run(jio_memory.VideoMemory(clip), background0=plate)


def test_streaming_matches_process_clip(jax_full):
    clip, plate = clip_and_plate()
    ref_rows, _, _ = process_clip(clip, CFG, background0=plate, **CPU)
    rows = StreamingPipeline(CFG, **CPU).run(VideoMemory(clip), background0=plate)
    assert rows == ref_rows == jax_full and len(rows) > 50


def test_staged_route_streams_the_same_rows(jax_full):
    """use_pallas + force_staged: the staged route (K1 + K2 plain) under
    the same StreamingPipeline."""
    clip, plate = clip_and_plate()
    rows = StreamingPipeline(CFG, use_pallas=True, force_staged=True, **CPU).run(
        VideoMemory(clip), background0=plate)
    assert rows == jax_full


def test_checkpoint_resume_equivalence(tmp_path, jax_full):
    """Interrupt mid-stream; resume must produce the identical rows as one
    uninterrupted run."""
    clip, plate = clip_and_plate()
    ckpt = str(tmp_path / "state.npz")
    sp = StreamingPipeline(CFG, checkpoint_path=ckpt, checkpoint_every=10**9, **CPU)
    sp.run(VideoMemory(clip[:32]), background0=plate)
    carry, rows_half = load_checkpoint(ckpt, CFG, **CPU)
    assert int(carry.frame_idx) == 32 and len(rows_half) > 0
    sp2 = StreamingPipeline(CFG, checkpoint_path=ckpt, checkpoint_every=10**9, **CPU)
    rows = sp2.run(VideoMemory(clip), background0=plate, resume=True)
    assert rows == jax_full


def test_row_log_mode_resume_equivalence(tmp_path, jax_full):
    """Append-only RowLog mode: checkpoints store only the row count, rows
    stream to disk, resume truncates the log — final rows identical to the
    in-memory run AND to an interrupted+resumed run."""
    clip, plate = clip_and_plate()
    sp = StreamingPipeline(CFG, checkpoint_path=str(tmp_path / "state.npz"),
                           checkpoint_every=2, row_log_path=str(tmp_path / "rows.bin"), **CPU)
    arr = sp.run(VideoMemory(clip), background0=plate)
    assert isinstance(arr, np.ndarray) and arr.shape[1] == 5
    assert as_tuples(arr) == jax_full

    ckpt2, rlogp2 = str(tmp_path / "state2.npz"), str(tmp_path / "rows2.bin")
    sp1 = StreamingPipeline(CFG, checkpoint_path=ckpt2, checkpoint_every=3,
                            row_log_path=rlogp2, **CPU)
    # 28 frames: the snapshot after batch 3 (24 frames) is the last one, as
    # the padded tail batch writes none, so the log holds rows past it
    sp1.run(VideoMemory(clip[:28]), background0=plate)
    assert RowLog(rlogp2).count() > load_checkpoint(ckpt2, CFG, **CPU)[1]
    sp2 = StreamingPipeline(CFG, checkpoint_path=ckpt2, checkpoint_every=3,
                            row_log_path=rlogp2, **CPU)
    arr2 = sp2.run(VideoMemory(clip), background0=plate, resume=True)
    assert as_tuples(arr2) == jax_full


def test_checkpoint_config_mismatch_rejected(tmp_path):
    clip, plate = clip_and_plate(frames=16)
    ckpt = str(tmp_path / "state.npz")
    StreamingPipeline(CFG, checkpoint_path=ckpt, **CPU).run(VideoMemory(clip), background0=plate)
    other = dataclasses.replace(CFG, segment=SegmentConfig(threshold=50.0, min_area=20, max_blobs=4))
    with pytest.raises(ValueError):
        load_checkpoint(ckpt, other, **CPU)


def test_padded_tail_checkpoint_skipped(tmp_path):
    """The final checkpoint is not written from a pad-perturbed carry; the
    last periodic checkpoint stays authoritative."""
    clip, _, plate = moving_disk_clip(h=64, w=96, frames=44, radius=6, seed=3)
    ckpt = str(tmp_path / "tail.npz")
    # 44 frames, batch 8 -> 5 full batches + a padded tail of 4
    StreamingPipeline(CFG, checkpoint_path=ckpt, checkpoint_every=5, **CPU).run(
        VideoMemory(clip), background0=plate)
    carry, _rows = load_checkpoint(ckpt, CFG, **CPU)
    assert int(carry.frame_idx) == 40


def test_async_drainer_exact_sums():
    """row_sums round-trip exactly, including int32 extremes and values
    whose bit patterns are float32 denormals, NaNs and infinities; rows,
    flags and counts pass unchanged, in submission order, and a consumer
    error re-raises at the next producer call."""
    N, K = 3, 4
    rng = np.random.default_rng(7)
    rows = rng.normal(size=(N, K, 5)).astype(np.float32)
    valid = rng.random((N, K)) < 0.7
    sums = np.array(
        [1, 73000, -5, -1, 2**31 - 1, -(2**31), 0x7F800001 - 2**32, 0x00400000] * 3,
    ).astype(np.int64).astype(np.int32).reshape(N, K, 2)
    out = {
        "rows": torch.from_numpy(rows),
        "row_valid": torch.from_numpy(valid),
        "row_sums": torch.from_numpy(sums),
        "stats_overflow": torch.zeros((N,), dtype=torch.int32),
        "ccl_converged": True,
        "active_tracks": torch.tensor(5, dtype=torch.int32),
        "masks": torch.zeros((N, 4, 4), dtype=torch.uint8),
    }
    got = []
    dr = AsyncRowDrainer(lambda rec, n: got.append((rec, n)), group=2)
    try:
        dr.submit(out, n=2)
        dr.submit(out)
        dr.submit(out, n=1)
        dr.flush()
    finally:
        dr.close()
    assert [n for _, n in got] == [2, 3, 1]
    rec = got[0][0]
    assert np.array_equal(rec["row_sums"], sums) and rec["row_sums"].dtype == np.int32
    assert np.array_equal(rec["row_valid"], valid)
    assert np.array_equal(rec["rows"], rows)
    assert rec["active_tracks"] == 5 and rec["ccl_converged"] is True
    assert np.array_equal(rec["stats_overflow"], np.zeros(N, np.int32))
    assert set(rec) == {"rows", "row_valid", "row_sums", "active_tracks",
                        "stats_overflow", "ccl_converged"}

    def fail(rec, n):
        raise RuntimeError("consumer failed")

    dr = AsyncRowDrainer(fail, group=1)
    dr.submit(out)
    with pytest.raises(RuntimeError, match="consumer failed"):
        dr.flush()
    dr.kill()
    assert not dr._thread.is_alive()


def test_check_capacity_strict_and_warn():
    rec = {"stats_overflow": np.array([0, 3, 0]), "ccl_converged": True}
    with pytest.raises(RuntimeError, match="overflow"):
        StreamingPipeline(CFG, strict=True, **CPU)._check_capacity(rec, 3)
    sp = StreamingPipeline(CFG, strict=False, **CPU)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sp._check_capacity(rec, 3)
        sp._check_capacity({"ccl_converged": False}, 3)
    assert sp.overflow_frames == 1 and sp.ccl_unconverged_batches == 1 and len(w) == 2
    sp._check_capacity(rec, 1)  # the overflowing frame is padding


def test_streaming_warmup_compiles_without_state():
    """warmup() runs the step for (H, W) without touching checkpoint or
    row state; a following run() gives the rows of an un-warmed one."""
    clip, _truth, plate = moving_disk_clip(h=48, w=64, frames=32, radius=6, noise_sigma=2.0)
    rows_cold = StreamingPipeline(CFG, **CPU).run(VideoMemory(clip), background0=plate)
    sp_warm = StreamingPipeline(CFG, **CPU)
    sp_warm.warmup(48, 64)
    assert sp_warm.active_tracks == 0 and sp_warm.overflow_frames == 0
    assert sp_warm.run(VideoMemory(clip), background0=plate) == rows_cold


def test_row_log_fresh_run_discards_stale_rows(tmp_path):
    clip, plate = clip_and_plate(frames=32)
    rlogp = str(tmp_path / "rows.bin")
    first = StreamingPipeline(CFG, row_log_path=rlogp, **CPU).run(VideoMemory(clip), background0=plate)
    assert len(first) > 0
    again = StreamingPipeline(CFG, row_log_path=rlogp, **CPU).run(VideoMemory(clip), background0=plate)
    assert len(again) == len(first), "stale rows leaked into a fresh run"
    assert as_tuples(again) == as_tuples(first)
    ckpt = str(tmp_path / "state.npz")
    kw = dict(checkpoint_path=ckpt, checkpoint_every=2, row_log_path=rlogp, **CPU)
    StreamingPipeline(CFG, **kw).run(VideoMemory(clip), background0=plate, resume=False)
    final = StreamingPipeline(CFG, **kw).run(VideoMemory(clip), background0=plate, resume=False)
    assert len(final) == len(first)


@pytest.mark.parametrize("row_log", [False, True], ids=["embedded_rows", "row_log"])
def test_tpuva_checkpoint_resumes_in_port(tmp_path, jax_full, row_log):
    clip, plate = clip_and_plate()
    ckpt = str(tmp_path / "jax.npz")
    kw = dict(checkpoint_path=ckpt, checkpoint_every=3)
    if row_log:
        kw["row_log_path"] = str(tmp_path / "rows.bin")
    js.StreamingPipeline(CFG, **kw).run(jio_memory.VideoMemory(clip[:40]), background0=plate)
    rows = StreamingPipeline(CFG, **kw, **CPU).run(VideoMemory(clip), background0=plate)
    assert as_tuples(rows) == jax_full


def test_port_checkpoint_resumes_in_tpuva(tmp_path, jax_full):
    clip, plate = clip_and_plate()
    ckpt = str(tmp_path / "port.npz")
    StreamingPipeline(CFG, checkpoint_path=ckpt, checkpoint_every=10**9, **CPU).run(
        VideoMemory(clip[:24]), background0=plate)
    with np.load(ckpt) as z:
        fields = {k: (z[k].dtype, z[k].shape) for k in z.files}
    carry_j, _rows = js.load_checkpoint(ckpt, CFG)
    assert fields["bg"] == (np.float32, (96, 128)) and fields["frame_idx"] == (np.int32, ())
    assert fields["bg_valid"] == (np.bool_, ()) and fields["track_next_id"] == (np.int32, ())
    assert int(carry_j.frame_idx) == 24
    rows = js.StreamingPipeline(CFG, checkpoint_path=ckpt, checkpoint_every=10**9).run(
        jio_memory.VideoMemory(clip), background0=plate)
    assert rows == jax_full
    # and the same snapshot written by tpuva has the same fields and dtypes
    save_path = str(tmp_path / "jax_written.npz")
    js.save_checkpoint(save_path, carry_j, [], CFG)
    with np.load(save_path) as z:
        assert {k: (z[k].dtype, z[k].shape) for k in z.files} == dict(fields, rows=(np.float64, (0, 5)))


@pytest.mark.parametrize("use_native", [False, True])
def test_batch_stager_cpu_yields_source_batches(use_native):
    rng = np.random.default_rng(1)
    clip = rng.integers(0, 256, (21, 6, 10), dtype=np.uint8)
    st = BatchStager(VideoMemory(clip), 8, use_native=use_native, **CPU)
    got = list(st)
    st.close()
    assert [n for n, _ in got] == [8, 8, 5]
    for (n, b), start in zip(got, (0, 8, 16)):
        assert b.dtype == torch.uint8 and b.shape == (8, 6, 10)
        np.testing.assert_array_equal(b[:n].numpy(), clip[start:start + n])
    np.testing.assert_array_equal(got[-1][1][5:].numpy(), np.repeat(clip[-1:], 3, axis=0))


class Decoded(tio_base.VideoBase):
    """A decoder's shape of source: frames only through get_frame."""

    def __init__(self, data):
        super().__init__(data.shape[0], (data.shape[2], data.shape[1]), 25.0, False)
        self.data = data

    def get_frame(self, index):
        return self.data[index]


def native_stagers(sp):
    """Record whether each stager that sp makes took the C++ ring."""
    seen, make = [], sp._make_stager

    def record(source):
        stager = make(source)
        seen.append(stager.native)
        return stager

    sp._make_stager = record
    return seen


def test_streaming_native_staging_matches_tpuva(jax_full, tmp_path):
    """A decoder's source goes through the C++ ring (the stager's own
    choice): the same rows, and a stopped run resumes through it."""
    clip, plate = clip_and_plate()
    sp = StreamingPipeline(CFG, **CPU)
    seen = native_stagers(sp)
    assert sp.run(Decoded(clip), background0=plate) == jax_full and seen == [True]
    ckpt = str(tmp_path / "state.npz")
    StreamingPipeline(CFG, checkpoint_path=ckpt, **CPU).run(Decoded(clip[:24]), background0=plate)
    sp = StreamingPipeline(CFG, checkpoint_path=ckpt, **CPU)
    seen = native_stagers(sp)
    assert sp.run(Decoded(clip), background0=plate) == jax_full and seen == [True]
    sp = StreamingPipeline(CFG, **CPU)
    seen = native_stagers(sp)
    assert sp.run(VideoMemory(clip), background0=plate) == jax_full and seen == [False]


def test_io_copies_match_originals():
    for name in ("VideoBase", "VideoSlice"):
        assert inspect.getsource(getattr(tio_base, name)) == inspect.getsource(getattr(jio_base, name))
    clip = np.arange(7 * 3 * 4, dtype=np.uint8).reshape(7, 3, 4)
    a, b = VideoMemory(clip), jio_memory.VideoMemory(clip)
    for va, vb in ((a, b), (a[2:], b[2:]), (a[1::3], b[1::3])):
        assert (va.frame_count, va.size, va.shape, va.fps) == (vb.frame_count, vb.size, vb.shape, vb.fps)
        for batch in (2, 3):
            for pad in (False, True):
                ga = list(va.iter_batches(batch, pad_last=pad))
                gb = list(vb.iter_batches(batch, pad_last=pad))
                assert [n for n, _ in ga] == [n for n, _ in gb]
                for (_, x), (_, y) in zip(ga, gb):
                    np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(va.to_array(), vb.to_array())
    assert inspect.getsource(VideoMemory).replace("tpuva_torch", "tpuva") == \
        inspect.getsource(jio_memory.VideoMemory)


def test_batch_logger_copy_matches_original():
    assert inspect.getsource(tutils.BatchLogger) == inspect.getsource(jutils.BatchLogger)
    out = io.StringIO()
    lg = tutils.BatchLogger(out=out, every=0.0)
    lg.log(8, queue=1)
    rec = json.loads(out.getvalue())
    assert rec["frames"] == 8 and rec["queue"] == 1
