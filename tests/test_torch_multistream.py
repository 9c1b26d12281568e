"""The port's multistream path (tpuva_torch.dist) against tpuva's single-chip
multistream processor and MultiStreamPipeline (mesh=None) on the JAX CPU
backend (Pallas in interpret mode where use_pallas asks for it).

Every stream has its own clip (a moving disk, its own seed) and its own
plate, so a stream-index mistake in K1's or K5's stream axis shows. Rows,
validity, sums, detections, the track table and frame indices are
compared bit for bit; the background to rtol 1e-5, since XLA:CPU
FMA-contracts the reference's update and the port keeps two roundings
(ROADMAP Queue 3, R1). Also: every stream equals the port's single-stream
process_batch on it; the stream-axis plain versions of K1 and K5 (what the
card's kernels are held to) equal S single-stream calls; the pipeline's
resume, row-log mode, HDF5 export and checkpoints across packages.
"""

import warnings

import h5py
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuva.dist as jd
import tpuva.graph.config as jcfg
from refimpl.synthetic import moving_disk_clip
from tpuva.io.memory import VideoMemory as JVideoMemory
from tpuva_torch.dist import (
    MultiStreamPipeline,
    init_multistream_carry,
    load_multistream_checkpoint,
    make_multistream_processor,
    make_stream_mesh,
    merge_stream_rows,
)
from tpuva_torch.dist.multistream import stack_stream_carries
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph.pipeline import init_carry, process_batch
from tpuva_torch.io.memory import VideoMemory
from tpuva_torch.ops.fused_segment import (
    MAX_STREAMS, fused_segment, fused_segment_plain, run_streams,
)
from tpuva_torch.scenes import det_sequence
from tpuva_torch.track.scan import track_scan, track_scan_plain
from tpuva_torch.track.table import TrackState, init_track_state
from test_torch_kernels import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")
OUT_KEYS = ("rows", "row_valid", "row_sums", "n_det", "active_tracks")


def cfg(module=jcfg, threshold=40.0):
    """The bench config's stages at test size: blur 5, open 3 rect, close 3
    ellipse."""
    return module.PipelineConfig(
        background=module.BackgroundConfig(alpha=0.02),
        blur=module.BlurConfig(ksize=5),
        morph_open=module.MorphConfig(ksize=3),
        morph_close=module.MorphConfig(ksize=3, shape="ellipse"),
        segment=module.SegmentConfig(threshold=threshold, min_area=20, max_blobs=4),
        track=module.TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8,
                                 assigner="hungarian"),
        batch=8,
    )


def make_streams(S, T=16, h=64, w=96, seed=0):
    """(clips (S, T, h, w) uint8, plates (S, h, w) float32): a moving disk a
    stream, its own seed, and its own plate (the clip's, lifted by s)."""
    clips, plates = [], []
    for s in range(S):
        clip, _truth, plate = moving_disk_clip(h=h, w=w, frames=T, radius=6, seed=seed + s)
        clips.append(clip)
        plates.append(plate.astype(np.float32) + s)
    return np.stack(clips), np.stack(plates)


def run_tpuva(c, S, clips, plates, **kw):
    fn = jd.make_multistream_processor(c, S, mesh=None, **kw)
    carry = jd.init_multistream_carry(c, clips.shape[2], clips.shape[3], S, background0=plates)
    outs = []
    for start in range(0, clips.shape[1], c.batch):
        carry, out = fn(carry, jnp.asarray(clips[:, start:start + c.batch]))
        outs.append({k: np.asarray(out[k]) for k in OUT_KEYS})
    return carry, outs


def run_port(c, S, clips, plates, as_list=False, **kw):
    kw = dict(CPU, **kw)
    fn = make_multistream_processor(c, S, **kw)
    carry = init_multistream_carry(c, clips.shape[2], clips.shape[3], S, background0=plates,
                                   **CPU)
    outs = []
    for start in range(0, clips.shape[1], c.batch):
        frames = torch.from_numpy(np.ascontiguousarray(clips[:, start:start + c.batch]))
        carry, out = fn(carry, list(frames) if as_list else frames)
        outs.append({k: out[k].numpy() for k in OUT_KEYS})
    return carry, outs


def assert_carry_equal(carry, carry_j):
    for f in TrackState._fields:
        np.testing.assert_array_equal(getattr(carry.track, f).numpy(),
                                      np.asarray(getattr(carry_j.track, f)), err_msg=f)
    np.testing.assert_array_equal(carry.frame_idx.numpy(), np.asarray(carry_j.frame_idx))
    np.testing.assert_array_equal(carry.bg_valid.numpy(), np.asarray(carry_j.bg_valid))
    np.testing.assert_allclose(carry.bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)


# (threshold, streams, options, plates): each route of the processor
CASES = {
    "fixed": (40.0, 3, {}, True),
    "fixed_seeded": (40.0, 2, {}, False),
    "otsu": ("otsu", 2, {}, True),
    "single_pass": (40.0, 2, dict(ccl_single_pass=True), True),
    "parallel_bg": (40.0, 3, dict(parallel_bg=True), True),
    "use_pallas": (40.0, 3, dict(use_pallas=True), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_processor_matches_tpuva(case):
    """Two steps of S streams: every output field and the carry equal
    tpuva's multistream processor (mesh=None); use_pallas runs tpuva's
    lax.map over its Pallas front end in interpret mode."""
    threshold, S, kw, with_plates = CASES[case]
    clips, plates = make_streams(S, seed=3 * S)
    plates = plates if with_plates else None
    carry_j, outs_j = run_tpuva(cfg(jcfg, threshold), S, clips, plates, **kw)
    carry, outs = run_port(cfg(tcfg, threshold), S, clips, plates, as_list=case == "fixed", **kw)
    for step, (o, oj) in enumerate(zip(outs, outs_j)):
        for k in OUT_KEYS:
            np.testing.assert_array_equal(o[k], oj[k], err_msg=f"step {step}: {k}")
    assert all(o["row_valid"].sum() for o in outs)
    assert_carry_equal(carry, carry_j)


def test_every_stream_is_its_single_stream_route():
    """S = 8: each stream's outputs, carry and background equal the port's
    single-stream process_batch on that stream, bit for bit."""
    S = 8
    clips, plates = make_streams(S, seed=40)
    c = cfg(tcfg)
    carry, outs = run_port(c, S, clips, plates)
    for s in range(S):
        one = init_carry(c, 64, 96, plates[s], **CPU)
        for step, start in enumerate(range(0, clips.shape[1], c.batch)):
            one, out = process_batch(c, one, torch.from_numpy(clips[s, start:start + c.batch]))
            for k in OUT_KEYS:
                np.testing.assert_array_equal(outs[step][k][s], out[k].numpy(),
                                              err_msg=f"stream {s}, step {step}: {k}")
        assert torch.equal(carry.bg[s], one.bg)
        for a, b in zip(carry.track, one.track):
            assert torch.equal(a[s], b)


def k1_streams(S, N=6, H=40, W=56, seed=0):
    """S streams of random frames with moving bright boxes, each with its
    own plate (bg0 (S, H, W) float32, distinct per stream)."""
    rng = np.random.default_rng(seed)
    plates = rng.uniform(10, 60, (S, 1, 1)) + rng.uniform(0, 4, (S, H, W))
    frames = plates[:, None] + rng.normal(0, 3, (S, N, H, W))
    for s in range(S):
        for t in range(N):
            y, x = (3 * t + 5 * s) % (H - 8), (4 * t + 7 * s) % (W - 8)
            frames[s, t, y:y + 8, x:x + 8] = 200
    return (torch.from_numpy(np.clip(np.rint(frames), 0, 255).astype(np.uint8)),
            torch.from_numpy(plates.astype(np.float32)))


# every option of fused_segment, as it hands them to run_split
K1_KW = dict(alpha=0.05, threshold=25.0, blur_ksize=5, blur_sigma=0.0, median_ksize=0,
             open_shape="rect", open_ksize=3, open_iters=1, close_shape="ellipse",
             close_ksize=3, close_iters=1, emit="mask")


@pytest.mark.parametrize("emit", ["mask", "diff", "padded_occ"])
def test_k1_stream_axis_plain_equals_single_calls(emit):
    """The stream-axis plain K1 (a stack, a list, a mixed seed tensor, one
    flag for all) equals S single-stream calls with each stream's plate and
    seed flag; and run_streams, the card's form, with the plain version in
    K1's place, on one pass (one call for all streams) and on a split
    (a stream at a time)."""
    S = 3
    frames, bg0 = k1_streams(S)
    kw = dict(K1_KW, padded_occ=emit == "padded_occ")
    if emit == "diff":
        kw.update(threshold=0.0, open_ksize=0, close_ksize=0, emit="diff")
    seeds = [True, False, True]
    seed_t = torch.tensor(seeds)
    singles = [fused_segment_plain(frames[s], bg0[s], seed_bg=seeds[s], **kw) for s in range(S)]
    for what, got in (
            ("stack", fused_segment(frames, bg0, seed_bg=seed_t, **kw)),
            ("list", fused_segment(list(frames), bg0, seed_bg=seed_t, **kw)),
            ("plain", fused_segment_plain(frames, bg0, seed_bg=seed_t, **kw))):
        assert len(got) == len(singles[0])
        for i, x in enumerate(got):
            assert x.shape[0] == S
            for s in range(S):
                assert torch.equal(x[s], singles[s][i]), (what, i, s)
    for flag in (False, True):
        got = fused_segment(frames, bg0, seed_bg=flag, **kw)
        for s in range(S):
            ref = fused_segment_plain(frames[s], bg0[s], seed_bg=flag, **kw)
            assert all(torch.equal(a[s], b) for a, b in zip(got, ref))
    opts = {k: v for k, v in kw.items() if k != "padded_occ"}
    for parts in ((False, False), (True, True) if emit != "diff" else (True, False)):
        got = run_streams(list(frames), bg0, parts, fused_segment_plain,
                          padded_occ=kw["padded_occ"], **dict(opts, seed_bg=seed_t))
        for s in range(S):
            assert all(torch.equal(a[s], b) for a, b in zip(got, singles[s])), parts


def test_k1_stream_axis_checks_and_chunks():
    """MAX_STREAMS streams are one call of the card's form; past that, or
    with no stream, fused_segment raises; a wrong plate or seed shape
    raises."""
    S = MAX_STREAMS
    frames, bg0 = k1_streams(S + 1, N=2, H=16, W=24, seed=1)
    seeds = torch.arange(S + 1) % 3 == 0
    calls = []

    def k1(fr, bg, **kw):
        calls.append(len(fr))
        return fused_segment_plain(fr, bg, **kw)

    got = run_streams(list(frames[:S]), bg0[:S], (False, False), k1,
                      **dict(K1_KW, seed_bg=seeds[:S]))
    assert calls == [S]
    ref = fused_segment(frames[:S], bg0[:S], seed_bg=seeds[:S], **K1_KW)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="streams"):
        fused_segment(frames, bg0, seed_bg=seeds, **K1_KW)
    with pytest.raises(ValueError, match="streams"):
        fused_segment([], bg0[:0], **K1_KW)
    with pytest.raises(ValueError, match="bg0"):
        fused_segment(frames[:S], bg0[0], **K1_KW)
    with pytest.raises(ValueError, match="seed_bg"):
        fused_segment(frames[:S], bg0[:S], seed_bg=seeds[:3], **K1_KW)


# (max_tracks, max_blobs): the bench's table, the register kernel's edge
# (32 x 32) and past it (33, 40: the table kernel)
K5_TABLES = [(16, 8), (32, 32), (33, 40)]


@pytest.mark.parametrize("T,D", K5_TABLES, ids=[f"T{t}-D{d}" for t, d in K5_TABLES])
def test_k5_stream_axis_plain_equals_single_calls(T, D):
    """track_scan with a stream axis (each stream a different det_sequence
    kind, its own table and frame index) equals S single-stream calls,
    bit for bit, from a fresh table and from the state it leaves."""
    kinds = ("churn", "contested", "crowd", "cloud", "empty")
    S, N = len(kinds), 12
    seqs = [det_sequence(k, D, frames=2 * N, seed=T + s) for s, k in enumerate(kinds)]
    dets = torch.from_numpy(np.stack([d for d, _ in seqs]))
    valid = torch.from_numpy(np.stack([v for _, v in seqs]))
    kw = dict(max_dist=40.0, death_patience=3, assigner="hungarian")
    state = TrackState(*(torch.stack(x) for x in zip(*[init_track_state(T, "cpu")] * S)))
    frame0 = torch.tensor([0, 7, 2**24 - 30, 100, 3], dtype=torch.int32)
    singles = [init_track_state(T, "cpu") for _ in range(S)]
    for half in range(2):
        sl = slice(half * N, (half + 1) * N)
        got = track_scan(state, dets[:, sl], valid[:, sl], frame0 + half * N, **kw)
        for s in range(S):
            one = track_scan_plain(singles[s], dets[s, sl], valid[s, sl], frame0[s] + half * N,
                                   **kw)
            for a, b in zip(got[0], one[0]):
                assert torch.equal(a[s], b)
            for i in (1, 2):
                assert torch.equal(got[i][s], one[i])
            singles[s] = one[0]
        state = got[0]
    assert int(state.active.sum()) > 0


def test_merge_stream_rows_matches_tpuva():
    rng = np.random.default_rng(5)
    rows_by_stream = [[(int(rng.integers(1, 5)), int(f), float(rng.uniform(0, 96)),
                        float(rng.uniform(0, 64)), float(rng.integers(20, 90)))
                       for f in rng.permutation(12)] for _ in range(3)] + [[]]
    for with_stream in (False, True):
        assert merge_stream_rows(rows_by_stream, with_stream) == jd.merge_stream_rows(
            rows_by_stream, with_stream)


# ------------------------------------------------------ MultiStreamPipeline

MS_CFG = cfg(tcfg)
MS_CFG_J = cfg(jcfg)


def videos(clips, module):
    cls = VideoMemory if module == "port" else JVideoMemory
    return [cls(c) for c in clips]


@pytest.fixture(scope="module")
def drive():
    """tpuva's MultiStreamPipeline(mesh=None) on 3 streams of 24 frames (the
    last batch of each full) and its rows."""
    clips, plates = make_streams(3, T=24, seed=20)
    rows, merged = jd.MultiStreamPipeline(MS_CFG_J, 3, mesh=None).run(
        videos(clips, "tpuva"), background0=plates)
    return clips, plates, rows, merged


class Abort(Exception):
    pass


def abort_after(msp, n):
    """Make msp._save_checkpoint raise Abort on its (n + 1)-th call."""
    orig = type(msp)._save_checkpoint
    calls = {"n": 0}

    def bomb(self, carry, rows_state, c):
        calls["n"] += 1
        if calls["n"] > n:
            raise Abort()
        return orig(self, carry, rows_state, c)

    msp._save_checkpoint = bomb.__get__(msp)
    return msp


def test_pipeline_matches_tpuva_and_exports(drive, tmp_path):
    """rows_by_stream and merged equal tpuva's; stream_<s>.h5 and merged.h5
    hold tpuva's datasets."""
    clips, plates, rows_j, merged_j = drive
    S = len(clips)
    exp, exp_j = str(tmp_path / "port"), str(tmp_path / "tpuva")
    rows, merged = MultiStreamPipeline(MS_CFG, S, **CPU).run(
        videos(clips, "port"), background0=plates, export_dir=exp)
    assert rows == rows_j and merged == merged_j and all(rows)
    jd.MultiStreamPipeline(MS_CFG_J, S, mesh=None).run(
        videos(clips, "tpuva"), background0=plates, export_dir=exp_j)
    for name in [f"stream_{s}.h5" for s in range(S)] + ["merged.h5"]:
        with h5py.File(f"{exp}/{name}", "r") as f, h5py.File(f"{exp_j}/{name}", "r") as g:
            assert sorted(f) == sorted(g)
            for key in f:
                assert f[key].dtype == g[key].dtype
                np.testing.assert_array_equal(f[key][...], g[key][...])
                assert dict(f[key].attrs).keys() == dict(g[key].attrs).keys()


@pytest.mark.parametrize("row_log", [False, True], ids=["embedded_rows", "row_log"])
def test_pipeline_resume_after_fault(drive, tmp_path, row_log):
    """Stopped after its second checkpoint (a fault injected through
    _save_checkpoint) and resumed, a run gives tpuva's uninterrupted rows;
    row-log mode too, with the mode mismatch raising."""
    clips, plates, rows_j, merged_j = drive
    S = len(clips)
    ckpt = str(tmp_path / "ms.npz")
    kw = dict(checkpoint_path=ckpt, **CPU)
    if row_log:
        kw["row_log_dir"] = str(tmp_path / "logs")
    msp = abort_after(MultiStreamPipeline(MS_CFG, S, checkpoint_every=1, **kw), 2)
    with pytest.raises(Abort):
        msp.run(videos(clips, "port"), background0=plates)
    with np.load(ckpt) as z:
        assert ("row_counts" in z) == row_log and int(z["frame_idx"].max()) == 16
    rows, merged = MultiStreamPipeline(MS_CFG, S, checkpoint_every=10**9, **kw).run(
        videos(clips, "port"), background0=plates)
    assert rows == rows_j and merged == merged_j
    if row_log:
        with pytest.raises(ValueError, match="row_log_dir"):
            MultiStreamPipeline(MS_CFG, S, checkpoint_path=ckpt, **CPU).run(
                videos(clips, "port"), background0=plates)


def test_row_log_fresh_run_discards_stale_rows(drive, tmp_path):
    clips, plates, rows_j, _merged = drive
    S = len(clips)
    logdir = str(tmp_path / "logs")
    for _ in range(2):
        rows, _m = MultiStreamPipeline(MS_CFG, S, row_log_dir=logdir, **CPU).run(
            videos(clips, "port"), background0=plates)
        assert rows == rows_j
        assert all(type(v) is t for r in rows[0] for v, t in zip(r, (int, int, float, float,
                                                                       float)))


def test_unequal_lengths_and_stream_count_raise(drive):
    clips, plates, _rows, _merged = drive
    msp = MultiStreamPipeline(MS_CFG, 3, **CPU)
    with pytest.raises(ValueError, match="equal length"):
        msp.run([VideoMemory(clips[0]), VideoMemory(clips[1][:16]), VideoMemory(clips[2])],
                background0=plates)
    with pytest.raises(ValueError, match="expected 3 videos"):
        msp.run(videos(clips[:2], "port"), background0=plates[:2])


def test_strict_overflow(drive):
    """A step whose stats overflow on a real frame raises when strict and
    warns and counts otherwise; overflow on a padded frame is ignored."""
    clips, plates, rows_j, _merged = drive
    clips = clips[:, :20]  # the last batch: 4 frames and 4 of padding

    def overflowing(msp, frame):
        fn = msp._fn

        def wrapped(carry, frames):
            carry, out = fn(carry, frames)
            ov = out["stats_overflow"].clone()
            ov[1, frame] = 2
            return carry, dict(out, stats_overflow=ov)

        msp._fn = wrapped
        return msp

    with pytest.raises(RuntimeError, match="overflow"):
        overflowing(MultiStreamPipeline(MS_CFG, 3, **CPU), 2).run(
            videos(clips, "port"), background0=plates)
    lax = overflowing(MultiStreamPipeline(MS_CFG, 3, strict=False, **CPU), 2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        lax.run(videos(clips, "port"), background0=plates)
    assert lax.overflow_frames == 3 and any("overflow" in str(x.message) for x in w)
    padded = overflowing(MultiStreamPipeline(MS_CFG, 3, strict=False, **CPU), 6)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        rows, _m = padded.run(videos(clips, "port"), background0=plates)
    assert padded.overflow_frames == 2  # the last step's frame 6 is padding
    assert rows == [[r for r in rs if r[1] < 20] for rs in rows_j]


@pytest.mark.parametrize("writer", ["tpuva", "port"])
def test_checkpoints_cross_packages(drive, tmp_path, writer):
    """A checkpoint written by either package after 16 frames resumes in
    the other to the uninterrupted rows (the same npz keys and dtypes)."""
    clips, plates, rows_j, merged_j = drive
    S = len(clips)
    ckpt = str(tmp_path / f"{writer}.npz")
    if writer == "tpuva":
        jd.MultiStreamPipeline(MS_CFG_J, S, mesh=None, checkpoint_path=ckpt).run(
            videos(clips[:, :16], "tpuva"), background0=plates)
        rows, merged = MultiStreamPipeline(MS_CFG, S, checkpoint_path=ckpt, **CPU).run(
            videos(clips, "port"), background0=plates)
    else:
        MultiStreamPipeline(MS_CFG, S, checkpoint_path=ckpt, **CPU).run(
            videos(clips[:, :16], "port"), background0=plates)
        carry, saved = load_multistream_checkpoint(ckpt, MS_CFG, S, **CPU)
        carry_j, saved_j = jd.load_multistream_checkpoint(ckpt, MS_CFG_J, S)
        assert_carry_equal(carry, carry_j)
        assert saved == saved_j
        with np.load(ckpt) as z:
            assert z["bg"].dtype == np.float32 and z["frame_idx"].dtype == np.int32
            assert z["bg_valid"].shape == (S,) and z["track_next_id"].dtype == np.int32
        rows, merged = jd.MultiStreamPipeline(MS_CFG_J, S, mesh=None, checkpoint_path=ckpt).run(
            videos(clips, "tpuva"), background0=plates)
    assert rows == rows_j and merged == merged_j
    with pytest.raises(ValueError, match="stream count"):
        load_multistream_checkpoint(ckpt, MS_CFG, S + 1, **CPU)


# ------------------------------------------------------ the ('stream',) mesh

def test_make_stream_mesh_and_auto():
    """make_stream_mesh takes the first n devices and raises tpuva's error
    on fewer (no CPU fallback); mesh="auto" builds none on the CPU."""
    cpu = torch.device("cpu")
    assert make_stream_mesh(2, ["cpu"] * 3) == (cpu, cpu)
    with pytest.raises(ValueError, match=r"need 4 devices for a \('stream',\) mesh, have 3"):
        make_stream_mesh(4, [cpu] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="have 0"):
            make_stream_mesh(1)
    assert MultiStreamPipeline(MS_CFG, 3, **CPU).mesh is None
    with pytest.raises(ValueError, match="not n_streams=3"):
        make_multistream_processor(MS_CFG, 3, mesh=make_stream_mesh(2, [cpu] * 2))


@pytest.mark.parametrize("case", ["fixed", "otsu"])
def test_mesh_processor_matches_stream_axis(case):
    """Two steps of S streams, a stream a device of a CPU mesh: every
    output field equals the stream axis's, and the per-stream carries it
    returns, stacked, equal the stream axis's carry bit for bit."""
    threshold, S, _kw, _plates = CASES[case]
    clips, plates = make_streams(S, seed=7)
    c = cfg(tcfg, threshold)
    carry, outs = run_port(c, S, clips, plates)
    carry_m, outs_m = run_port(c, S, clips, plates, as_list=True,
                               mesh=make_stream_mesh(S, ["cpu"] * S))
    assert isinstance(carry_m, tuple) and len(carry_m) == S
    for step, (o, om) in enumerate(zip(outs, outs_m)):
        for k in OUT_KEYS:
            np.testing.assert_array_equal(om[k], o[k], err_msg=f"step {step}: {k}")
    stacked = stack_stream_carries(carry_m, "cpu")
    for a, b in zip(stacked, carry):
        for x, y in (zip(a, b) if isinstance(a, TrackState) else [(a, b)]):
            assert torch.equal(x, y)


def test_pipeline_on_a_stream_mesh_matches_tpuva_mesh(drive, tmp_path):
    """MultiStreamPipeline on a CPU mesh of S devices (each stream staged
    and run on its own) gives the stream axis's rows and tpuva's on its
    simulated ('stream',) mesh (its tests/test_multistream.py:92); its
    checkpoint, the gathered stacked carry, resumes on the stream axis."""
    clips, plates, rows_j, merged_j = drive
    S = len(clips)
    mesh = make_stream_mesh(S, ["cpu"] * S)
    rows, merged = MultiStreamPipeline(MS_CFG, S, mesh=mesh, **CPU).run(
        videos(clips, "port"), background0=plates)
    assert rows == rows_j and merged == merged_j and all(rows)
    rows_jm, merged_jm = jd.MultiStreamPipeline(MS_CFG_J, S, mesh=jd.make_stream_mesh(S)).run(
        videos(clips, "tpuva"), background0=plates)
    assert rows == rows_jm and merged == merged_jm
    ckpt = str(tmp_path / "ms.npz")
    MultiStreamPipeline(MS_CFG, S, mesh=mesh, checkpoint_path=ckpt, **CPU).run(
        videos(clips[:, :8], "port"), background0=plates)
    carry, _saved = load_multistream_checkpoint(ckpt, MS_CFG, S, **CPU)
    assert tuple(carry.bg.shape) == (S,) + clips.shape[2:]
    assert carry.frame_idx.tolist() == [8] * S
    resumed, _m = MultiStreamPipeline(MS_CFG, S, checkpoint_path=ckpt, **CPU).run(
        videos(clips, "port"), background0=plates)
    assert resumed == rows
