"""The port's streamed pipeline on a ('space',) mesh (SpatialStreamPipeline, 4
bands on the CPU) — ports of tpuva's tests/test_spatial_stream.py: it
gives the single-device StreamingPipeline's rows, its checkpoints hold the
gathered full-frame carry and resume on either pipeline in either package,
its RowLog mode resumes, a band's piece-table overflow raises under
strict, and bad geometry raises.
"""

import numpy as np
import pytest
import torch

import tpuva.dist.pipeline as jdp
import tpuva.graph.config as jcfg
import tpuva.graph.streaming as jst
from refimpl.synthetic import moving_disk_clip
from tpuva.io import VideoMemory as JVideoMemory
from tpuva_torch.dist import SpatialStreamPipeline, make_space_mesh
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph.streaming import StreamingPipeline, load_checkpoint
from tpuva_torch.io.memory import VideoMemory
from test_torch_kernels import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
N_CHIPS = 4
MESH = make_space_mesh(N_CHIPS, [CPU] * N_CHIPS)


def cfg(module):
    return module.PipelineConfig(
        background=module.BackgroundConfig(alpha=0.05),
        blur=module.BlurConfig(ksize=5, sigma=0.0),
        morph_open=module.MorphConfig(ksize=3, shape="rect"),
        segment=module.SegmentConfig(threshold=35.0, min_area=20, max_blobs=4),
        track=module.TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=8,
    )


CFG = cfg(tcfg)


def clip_and_plate(frames=48):
    clip, _, plate = moving_disk_clip(h=96, w=128, frames=frames, radius=8, noise_sigma=3.0,
                                      seed=13)
    return clip, plate


def spatial(**kw):
    return SpatialStreamPipeline(CFG, N_CHIPS, mesh=MESH, **kw)


def single(**kw):
    return StreamingPipeline(CFG, device="cpu", **kw)


@pytest.fixture(scope="module")
def full_runs():
    """The whole clip through the single-device pipeline and the band pipeline."""
    clip, plate = clip_and_plate()
    sp = spatial()
    rows = sp.run(VideoMemory(clip), background0=plate)
    return single().run(VideoMemory(clip), background0=plate), rows, sp.recon_rounds


def test_spatial_stream_matches_single_device(full_runs):
    """A streamed run over the mesh equals the single-device streamed run,
    row for row; every batch reconciled (the warm-up's step not listed)."""
    ref, rows, rounds = full_runs
    assert rows == ref and rows
    assert len(rounds) == 6 and min(rounds) >= 1


def test_spatial_stream_checkpoint_resume_equivalence(full_runs, tmp_path):
    """Stopped after half the clip, resumed on the mesh: the uninterrupted
    mesh run's rows; the checkpoint holds the gathered carry."""
    _ref, full, _rounds = full_runs
    clip, plate = clip_and_plate()
    ckpt = str(tmp_path / "state.npz")
    spatial(checkpoint_path=ckpt, checkpoint_every=10**9).run(VideoMemory(clip[:24]),
                                                              background0=plate)
    carry, _rows_half = load_checkpoint(ckpt, CFG, "cpu")
    assert int(carry.frame_idx) == 24
    assert tuple(carry.bg.shape) == (96, 128)  # gathered, not a band
    rows = spatial(checkpoint_path=ckpt, checkpoint_every=10**9).run(
        VideoMemory(clip), background0=plate, resume=True)
    assert rows == full


@pytest.mark.parametrize("writer,reader", [
    ("port_spatial", "port_single"), ("port_single", "port_spatial"),
    ("tpuva_spatial", "port_spatial"), ("port_spatial", "tpuva_single"),
])
def test_spatial_stream_checkpoint_interoperates(full_runs, tmp_path, writer, reader):
    """A checkpoint written after half the clip by one pipeline resumes on
    another, across packages too; the rows equal an uninterrupted run."""
    ref, _rows, _rounds = full_runs
    clip, plate = clip_and_plate()
    ckpt = str(tmp_path / "state.npz")
    once = dict(checkpoint_path=ckpt, checkpoint_every=10**9)
    writers = {
        "port_spatial": lambda: spatial(**once).run(VideoMemory(clip[:24]), background0=plate),
        "port_single": lambda: single(**once).run(VideoMemory(clip[:24]), background0=plate),
        "tpuva_spatial": lambda: jdp.SpatialStreamPipeline(cfg(jcfg), N_CHIPS, **once).run(
            JVideoMemory(clip[:24]), background0=plate),
    }
    writers[writer]()
    if reader == "tpuva_single":
        jcarry, _rows_half = jst.load_checkpoint(ckpt, cfg(jcfg))
        assert tuple(jcarry.bg.shape) == (96, 128)
        rows = jst.StreamingPipeline(cfg(jcfg), **once).run(JVideoMemory(clip), background0=plate)
    else:
        rows = (spatial if reader == "port_spatial" else single)(**once).run(
            VideoMemory(clip), background0=plate)
    assert rows == ref


def test_spatial_stream_row_log_resume(full_runs, tmp_path):
    """RowLog mode on the mesh: stopped after a mid-run checkpoint, resumed
    (the log truncated to it), the rows of the uninterrupted mesh run."""
    _ref, full, _rounds = full_runs
    clip, plate = clip_and_plate()
    kw = dict(checkpoint_path=str(tmp_path / "state.npz"), checkpoint_every=2,
              row_log_path=str(tmp_path / "rows.bin"))
    spatial(**kw).run(VideoMemory(clip[:24]), background0=plate)
    arr = spatial(**kw).run(VideoMemory(clip), background0=plate, resume=True)
    assert isinstance(arr, np.ndarray) and arr.shape[1] == 5
    assert [(int(r[0]), int(r[1]), float(r[2]), float(r[3]), float(r[4])) for r in arr] == full


def test_spatial_stream_strict_overflow_raises():
    """More component pieces in a band than its table holds raises under
    strict (naming max_components); otherwise warns and counts."""
    clip, plate = clip_and_plate(frames=8)
    rng = np.random.default_rng(5)
    clip = clip.copy()
    for t in range(8):
        for y, x in zip(rng.integers(0, 96, 60), rng.integers(0, 128, 60)):
            clip[t, y:y + 2, x:x + 2] = 255
    bare = tcfg.PipelineConfig(
        background=tcfg.BackgroundConfig(alpha=0.0),
        segment=tcfg.SegmentConfig(threshold=35.0, min_area=1, max_blobs=4),
        track=tcfg.TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=8,
    )
    with pytest.raises(RuntimeError, match="max_components"):
        SpatialStreamPipeline(bare, N_CHIPS, mesh=MESH, max_components=4).run(
            VideoMemory(clip), background0=plate)
    lax = SpatialStreamPipeline(bare, N_CHIPS, mesh=MESH, max_components=4, strict=False)
    with pytest.warns(UserWarning, match="piece-table overflow"):
        lax.run(VideoMemory(clip), background0=plate)
    assert lax.overflow_frames > 0


def test_spatial_stream_rejects_bad_geometry():
    """H not divisible by the mesh fails at the first step; a mesh of too
    few devices, and the default mesh of cards where there are none, fail
    when the pipeline is made; so does a device= in place of a mesh."""
    clip, plate = clip_and_plate(frames=8)
    sp = SpatialStreamPipeline(CFG, 5, mesh=make_space_mesh(5, [CPU] * 5))
    with pytest.raises(ValueError, match="divisible"):
        sp.run(VideoMemory(clip), background0=plate)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        SpatialStreamPipeline(CFG, 4, mesh=make_space_mesh(2, [CPU] * 2))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 4 devices, have 0"):
            SpatialStreamPipeline(CFG, 4)
    with pytest.raises(TypeError, match="mesh"):
        SpatialStreamPipeline(CFG, 4, mesh=MESH, device="cpu")
