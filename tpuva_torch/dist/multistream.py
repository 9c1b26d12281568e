"""Multi-stream processing on one card — port of ``tpuva/dist/multistream.py``
(BASELINE.json config 5: concurrent camera streams, each with its own
background and track table, results merged on the host).

tpuva runs its streams as a ``vmap`` (or a ``lax.map`` around its Pallas
kernels) on one chip, or one stream a chip under ``shard_map``. Here every
stream lies on one card and a step is one batch program over all of them,
``graph.pipeline.process_batch`` with its stream axis:

- the front end: kernel K1 over all S streams in one launch
  (``ops.fused_segment.fused_segment`` with a stream axis: each stream's
  frames read where its stager left them, its own background, its own
  seeding flag read on the card), the mask emit, or the diff emit then the
  Otsu tail on the S·N magnitudes; for a median k > 3, after one K1b and
  one K7 launch over the S·N frames (the median route); for the scanned
  background (tpuva's jnp branch) the torch front end once a stream;
- the per-frame stages on the S·N frames as one batch: K3 + K6
  (``connected_components_with_stats``), or K2 with ``ccl_single_pass``,
  then ``extract_detections``;
- the tracker: kernel K5 over all S streams in one launch
  (``track.scan.track_scan`` with a stream axis, a CTA a stream).

The carry stays on the card; nothing is read on the host. Streams never
share state, so every stream's output is the single-stream route's on
that stream. ``merge_stream_rows`` is a copy of tpuva's (jax-free), pinned
by ``tests/test_torch_multistream.py``.

With a ``('stream',)`` mesh (``make_stream_mesh``: a tuple of devices one
process drives, as tpuva's ``shard_map`` over its mesh) stream s runs
``process_batch`` on ``mesh[s]`` under that device, its carry held there:
no traffic between devices but the step's small outputs, stacked on
``mesh[0]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuva_torch.device import mesh_devices, on_device, resolve_device
from tpuva_torch.graph.pipeline import PipelineCarry, _stream_carry, init_carry, process_batch
from tpuva_torch.track.table import TrackState


def make_stream_mesh(n_streams: int, devices=None) -> tuple:
    """The ('stream',) mesh: the first n_streams of `devices` (default the
    visible cards), one stream each. Raises ValueError when there are
    fewer."""
    return mesh_devices(n_streams, devices, " for a ('stream',) mesh")


def stack_stream_carries(carries, device) -> PipelineCarry:
    """Per-stream carries (a stream mesh's) as one stacked carry on `device`."""
    def stack(xs):
        return torch.stack([x.to(device) for x in xs])

    return PipelineCarry(
        bg=stack([c.bg for c in carries]),
        bg_valid=stack([c.bg_valid for c in carries]),
        track=TrackState(*(stack(f) for f in zip(*(c.track for c in carries)))),
        frame_idx=stack([c.frame_idx for c in carries]),
    )


def split_stream_carry(carry, mesh) -> tuple:
    """A stacked carry (or per-stream carries) as stream s's carry on mesh[s]."""
    if isinstance(carry, PipelineCarry):
        carry = [_stream_carry(carry, s) for s in range(len(mesh))]
    return tuple(PipelineCarry(bg=c.bg.to(d), bg_valid=c.bg_valid.to(d),
                               track=TrackState(*(x.to(d) for x in c.track)),
                               frame_idx=c.frame_idx.to(d))
                 for c, d in zip(carry, mesh))


def init_multistream_carry(cfg, H: int, W: int, n_streams: int, background0=None,
                           device="cuda") -> PipelineCarry:
    """Stacked per-stream carries with a leading (n_streams,) axis on
    `device`: bg (S, H, W), bg_valid (S,), each TrackState field (S, T, ...),
    frame_idx (S,). background0: optional (S, H, W) per-stream plates."""
    device = resolve_device(device)
    carries = [init_carry(cfg, H, W, None if background0 is None else background0[s], device)
               for s in range(n_streams)]
    return PipelineCarry(
        bg=torch.stack([c.bg for c in carries]),
        bg_valid=torch.stack([c.bg_valid for c in carries]),
        track=TrackState(*(torch.stack(f) for f in zip(*(c.track for c in carries)))),
        frame_idx=torch.stack([c.frame_idx for c in carries]),
    )


def make_multistream_processor(cfg, n_streams: int, mesh=None, parallel_bg: bool = False,
                               max_components: int = 64, use_pallas: Optional[bool] = None,
                               ccl_single_pass: bool = False, device="cuda"):
    """Returns fn(carry, frames) -> (carry, out) for S = n_streams streams:
    carry as init_multistream_carry gives it, frames (S, N, H, W) uint8 or
    a sequence of S (N, H, W) batches on `device`. Every field of out that
    process_batch returns leads with (S,): rows (S, N, max_blobs, 5),
    row_valid (S, N, max_blobs), row_sums (S, N, max_blobs, 2), n_det
    (S, N), active_tracks (S,), stats_overflow (S, N); ccl_converged is
    one flag for the step.

    A step is process_batch with its stream axis, so it takes the same
    routes as process_batch a stream: use_pallas (None means False,
    process_batch's default) with a config K1 covers in one pass runs K1
    whatever parallel_bg says; ccl_single_pass takes K2 for the stats.
    Streams must be equal in N (lock-step).

    mesh (make_stream_mesh's, n_streams devices; device is then unused):
    stream s runs process_batch on mesh[s] under that device. carry is a
    stacked carry (split onto the mesh first) or the S per-stream carries
    that fn returns; frames S batches, stream s's copied to mesh[s] where
    it lies elsewhere; out as above, stacked on mesh[0]."""
    S = n_streams
    kw = dict(parallel_bg=parallel_bg, max_components=max_components,
              use_pallas=bool(use_pallas), ccl_single_pass=ccl_single_pass)
    if mesh is not None:
        mesh = tuple(mesh)
        if len(mesh) != S:
            raise ValueError(f"the mesh holds {len(mesh)} devices, not n_streams={S}")
        return _mesh_processor(cfg, mesh, kw)
    device = resolve_device(device)

    def fn(carry: PipelineCarry, frames):
        if len(frames) != S:
            raise ValueError(f"expected {S} streams of frames, got {len(frames)}")
        if carry.bg.device != device or tuple(carry.bg.shape[:-2]) != (S,):
            raise ValueError(f"the carry must hold {S} streams on {device}")
        if len({tuple(f.shape) for f in frames}) != 1:
            raise ValueError("every stream's batch must have the same shape (lock-step)")
        return process_batch(cfg, carry, frames, **kw)

    return fn


def _mesh_processor(cfg, mesh: tuple, kw: dict):
    """make_multistream_processor's function on a stream mesh."""
    S = len(mesh)

    def fn(carry, frames):
        if len(frames) != S:
            raise ValueError(f"expected {S} streams of frames, got {len(frames)}")
        if len({tuple(f.shape) for f in frames}) != 1:
            raise ValueError("every stream's batch must have the same shape (lock-step)")
        carries, outs = [], []
        for s, (c, dev) in enumerate(zip(split_stream_carry(carry, mesh), mesh)):
            with on_device(dev):
                c, out = process_batch(cfg, c, frames[s].to(dev), **kw)
            carries.append(c)
            outs.append(out)
        home = mesh[0]
        with on_device(home):
            out = {k: torch.stack([o[k].to(home) for o in outs])
                   for k in outs[0] if k != "ccl_converged"}
        out["ccl_converged"] = all(o["ccl_converged"] for o in outs)  # a bool a stream
        return tuple(carries), out

    return fn


def merge_stream_rows(rows_by_stream, with_stream: bool = False):
    """Deterministically merge per-stream trajectory rows: track ids are
    remapped to (stream-major) globally unique ids, rows sorted by
    (stream, track_id, frame) — the same (track_id, frame) order the
    single-stream exporters use, applied stream-major. Copy of
    tpuva.dist.multistream.merge_stream_rows.

    with_stream=True prepends the source stream index to every row
    (provenance for config-5 consumers): (stream, track_id_global, frame,
    x, y, area). rows_by_stream: list of row lists."""
    merged = []
    offset = 0
    for s, rows in enumerate(rows_by_stream):
        max_tid = 0
        for tid, frame, x, y, area in sorted(rows, key=lambda r: (r[0], r[1])):
            row = (tid + offset, frame, x, y, area)
            merged.append(((s,) + row) if with_stream else row)
            max_tid = max(max_tid, tid)
        offset += max_tid
    return merged

