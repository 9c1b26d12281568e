"""Host pipelines over several streams or bands — port of
``tpuva/dist/pipeline.py``: ``MultiStreamPipeline`` (config 5, S concurrent
camera streams with per-stream state and merged results) and its
checkpoints, and ``SpatialStreamPipeline`` (config 4's long recording,
each frame banded by rows across a ('space',) mesh).

    S videos -> S BatchStagers (each its own feeder thread and pinned ring,
    copying its stream's batches to the card) -> one multistream step over
    the S batches where they lie (K1 and K5 one launch each for all
    streams; on a ('stream',) mesh, stream s's process_batch on its own
    device, its stager staging there) -> AsyncRowDrainer (per-stream row
    collection off the main thread) -> periodic stacked-carry checkpoints
    -> merged export with stream provenance.

Checkpoints are npz files with tpuva's keys and dtypes, so a checkpoint
written by either package resumes in the other; a mesh's carry is gathered
into them. Not carried over: tpuva's transfer guard.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.dist.multistream import (
    init_multistream_carry,
    make_multistream_processor,
    make_stream_mesh,
    merge_stream_rows,
    split_stream_carry,
    stack_stream_carries,
)
from tpuva_torch.dist.spatial import make_space_mesh, make_spatial_processor
from tpuva_torch.graph.pipeline import (
    PipelineCarry,
    carry_to_numpy,
    collect_rows,
    collect_rows_array,
)
from tpuva_torch.graph.streaming import (
    AsyncRowDrainer,
    RowLog,
    StreamingPipeline,
    _atomic_savez,
    _carry_payload,
    _load_carry,
)
from tpuva_torch.io.base import VideoBase
from tpuva_torch.io.staging import BatchStager
from tpuva_torch.utils import BatchLogger


class SpatialStreamPipeline(StreamingPipeline):
    """The streamed pipeline on a ('space',) mesh: ONE long video, each
    frame's rows banded across n_chips devices (make_spatial_processor).

    It is StreamingPipeline — staging, AsyncRowDrainer, checkpoints, the
    RowLog mode, resume — with tpuva's overrides:

    - one BatchStager stages each batch, one host copy a frame, onto band
      0's device (mesh[0]); each band takes its rows with their halo from
      there, views where the bands share that device, a copy between
      cards otherwise;
    - the carry is placed on the mesh (the background's bands on their
      devices, the tracker on mesh[0]); checkpoints hold the gathered
      full-frame carry, so a band run's checkpoint resumes on the single
      device StreamingPipeline, and the reverse, in either package;
    - the step is make_spatial_processor's, built once per (H, W), its
      first run warmed up before the stager starts.

    H must divide by n_chips and the front end's halo fit one band
    (make_spatial_processor validates). use_pallas and ccl_single_pass are
    ignored, as in tpuva: the band program is its own device path.
    recon_rounds lists each batch's tp_recon_rounds."""

    def __init__(self, cfg, n_chips: int, mesh=None, **kw):
        if "device" in kw:
            raise TypeError("SpatialStreamPipeline runs on its mesh: pass mesh=, not device=")
        self.mesh = make_space_mesh(n_chips, mesh)
        super().__init__(cfg, device=self.mesh[0], **kw)
        self.n_chips = n_chips
        self._fns = {}  # (H, W) -> the band step
        self._warm = set()  # shapes whose first step already ran
        self.recon_rounds = []

    def _place_carry(self, carry: PipelineCarry) -> PipelineCarry:
        H = carry.bg.shape[0] if isinstance(carry.bg, torch.Tensor) else None
        if H is None or H % self.n_chips:
            return carry  # bands already, or a geometry the step rejects
        Hb = H // self.n_chips
        home = self.mesh[0]
        return PipelineCarry(
            bg=tuple(carry.bg[b * Hb:(b + 1) * Hb].to(d) for b, d in enumerate(self.mesh)),
            bg_valid=carry.bg_valid.to(home),
            track=type(carry.track)(*(x.to(home) for x in carry.track)),
            frame_idx=carry.frame_idx.to(home),
        )

    def _make_stager(self, source):
        W, H = source.size
        if (H, W) not in self._warm:
            self.warmup(H, W)
            self._warm.add((H, W))
            self.recon_rounds.clear()
        return super()._make_stager(source)

    def _step(self, cfg, carry, batch):
        key = (int(batch.shape[1]), int(batch.shape[2]))
        fn = self._fns.get(key)
        if fn is None:
            fn = make_spatial_processor(cfg, key[0], key[1], self.n_chips, mesh=self.mesh,
                                        max_components=self.max_components)
            self._fns[key] = fn
        carry, out = fn(carry, batch)
        self.recon_rounds.append(int(out["tp_recon_rounds"]))
        return carry, out

    def _overflow_message(self, bad: int, most: int) -> str:
        """stats_overflow counts the component PIECES a band's table
        (max_components entries) could not hold: their sums were dropped,
        so those frames' areas and centroids are inexact. tpuva's message."""
        return (f"spatial-TP band piece-table overflow on {bad} frame(s) "
                f"(max {most} pieces dropped): raise "
                f"max_components (={self.max_components}) for this workload")


def save_multistream_checkpoint(path: str, carry: PipelineCarry, rows_state, cfg) -> None:
    """Atomic snapshot of the stacked per-stream carry + rows (npz), with
    tpuva's keys and dtypes; a stream mesh's per-stream carries are
    gathered first.

    rows_state is either rows_by_stream (list of per-stream row lists,
    embedded in the snapshot) or a 1-D int array of per-stream durable
    RowLog counts (row-log mode: O(carry) snapshots, rows live in the
    append-only logs)."""
    if not isinstance(carry, PipelineCarry):
        carry = stack_stream_carries(carry, "cpu")
    payload = _carry_payload(carry, cfg)
    if isinstance(rows_state, np.ndarray) and rows_state.ndim == 1:
        payload["row_counts"] = rows_state.astype(np.int64)
    else:
        flat = [(s,) + tuple(r) for s, rows in enumerate(rows_state) for r in rows]
        payload["rows"] = np.asarray(flat, np.float64).reshape(-1, 6)
    _atomic_savez(path, payload)


def load_multistream_checkpoint(path: str, cfg, n_streams: int, device="cuda"):
    """Returns (carry on `device`, rows_by_stream) — or (carry, per-stream
    RowLog counts) for row-log-mode checkpoints — or raises (the config,
    compared as type(cfg) so either package's config class works, and the
    stream count must match)."""
    with np.load(path) as z:
        carry = _load_carry(z, cfg, device)
        if carry.bg.shape[0] != n_streams:
            raise ValueError("checkpoint has a different stream count")
        if "row_counts" in z:
            return carry, z["row_counts"].astype(np.int64)
        rows_by_stream = [[] for _ in range(n_streams)]
        for r in z["rows"]:
            rows_by_stream[int(r[0])].append(tuple(r[1:]))
        return carry, rows_by_stream


class MultiStreamPipeline:
    """Drive S equal-length videos through the multistream processor on
    `device` (the card unless device="cpu"), in lock-step.

    Each stream's batches are staged by its own BatchStager (its own
    feeder thread and pinned slots); a step hands the S batches, where
    they lie, to make_multistream_processor's function, which launches K1
    and K5 once for all streams. Rows drain off-thread through
    AsyncRowDrainer.

    mesh="auto" builds a ('stream',) mesh (make_stream_mesh) when the
    device is a card and at least n_streams cards are visible, else runs
    every stream on `device` as above — tpuva's rule. With a mesh, stream
    s is staged onto mesh[s] and runs there, one device a stream; mesh=None
    never builds one.

    row_log_dir enables the unbounded-stream mode (the multi-stream
    analog of StreamingPipeline's row_log_path): drained rows stream to
    one append-only RowLog per stream instead of host RAM, and
    checkpoints store only the per-stream durable row counts (O(carry)
    snapshots instead of re-embedding the full row history).

    Stats overflow raises when strict=True (default) and warns + counts
    (.overflow_frames) otherwise.
    """

    def __init__(
        self,
        cfg,
        n_streams: int,
        mesh="auto",
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 50,  # steps
        parallel_bg: bool = False,
        max_components: int = 64,
        queue_depth: int = 3,
        log: bool = False,
        use_pallas: Optional[bool] = None,
        row_log_dir: Optional[str] = None,
        ccl_single_pass: bool = False,
        strict: bool = True,
        device="cuda",
    ):
        self.cfg = cfg
        self.n_streams = n_streams
        self.row_log_dir = row_log_dir
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.queue_depth = queue_depth
        self.strict = strict
        self.device = resolve_device(device)
        if isinstance(mesh, str) and mesh == "auto":
            mesh = (make_stream_mesh(n_streams)
                    if self.device.type == "cuda" and torch.cuda.device_count() >= n_streams
                    else None)
        self.mesh = None if mesh is None else tuple(mesh)
        self.overflow_frames = 0
        self.logger = BatchLogger(enabled=log)
        self._fn = make_multistream_processor(
            cfg, n_streams, mesh=self.mesh, parallel_bg=parallel_bg,
            max_components=max_components, use_pallas=use_pallas,
            ccl_single_pass=ccl_single_pass, device=self.device,
        )

    def _stagers(self, videos: Sequence[VideoBase]):
        devs = self.mesh if self.mesh is not None else [self.device] * self.n_streams
        return [BatchStager(v, self.cfg.batch, queue_depth=self.queue_depth, device=d)
                for v, d in zip(videos, devs)]

    def _place_carry(self, carry: PipelineCarry):
        """The stacked carry on the mesh, stream s's on mesh[s] (as it is
        without a mesh)."""
        return carry if self.mesh is None else split_stream_carry(carry, self.mesh)

    def run(
        self,
        videos: Sequence[VideoBase],
        background0: Optional[np.ndarray] = None,  # (S, H, W)
        resume: bool = True,
        export_dir: Optional[str] = None,
    ):
        """Process all streams in lock-step. Returns (rows_by_stream,
        merged) where merged rows carry stream provenance:
        (stream, track_id_global, frame, x, y, area).

        With export_dir set, writes stream_<s>.h5 per stream plus
        merged.h5 (6-column trajectories with a stream column)."""
        cfg = self.cfg
        S = self.n_streams
        if len(videos) != S:
            raise ValueError(f"expected {S} videos, got {len(videos)}")
        counts = {v.frame_count for v in videos}
        if len(counts) != 1:
            raise ValueError(f"streams must be equal length (lock-step), got {counts}")
        total = counts.pop()
        W, H = videos[0].size

        use_log = self.row_log_dir is not None
        if use_log:
            os.makedirs(self.row_log_dir, exist_ok=True)
        rlogs = None  # opened only after checkpoint-mode validation

        def _open_logs():
            return [RowLog(os.path.join(self.row_log_dir, f"stream_{s}.rows"))
                    for s in range(S)]

        rows_by_stream = [[] for _ in range(S)]

        def finish():
            # read the logs back into the list-of-tuples form collect_rows
            # gives, so that both modes return, merge and export alike
            if use_log:
                out = []
                for rl in rlogs:
                    out.append([(int(r[0]), int(r[1]), float(r[2]), float(r[3]), float(r[4]))
                                for r in rl.read()])
                    rl.close()
                return out
            return rows_by_stream

        def rows_state():
            if use_log:
                return np.asarray([rl.count() for rl in rlogs], np.int64)
            return rows_by_stream

        carry = self._place_carry(init_multistream_carry(cfg, H, W, S, background0=background0,
                                                         device=self.device))
        start_frame = 0
        if resume and self.checkpoint_path and os.path.exists(self.checkpoint_path):
            carry, saved = load_multistream_checkpoint(self.checkpoint_path, cfg, S,
                                                       self.device)
            fidx = carry_to_numpy(carry).frame_idx  # the frame indices, read on the host once
            carry = self._place_carry(carry)
            if isinstance(saved, np.ndarray) and saved.ndim == 1:
                if not use_log:
                    raise ValueError("checkpoint stores RowLog counts but no row_log_dir was given")
                rlogs = _open_logs()
                for rl, cnt in zip(rlogs, saved):
                    rl.truncate(int(cnt))
            else:
                if use_log:
                    raise ValueError("checkpoint embeds rows but row_log_dir is set")
                rows_by_stream = saved
            if not (fidx == fidx[0]).all():
                raise ValueError(f"checkpoint streams out of lock-step: frame_idx {fidx}")
            start_frame = int(fidx[0])
        if use_log and rlogs is None:
            # fresh (non-resume) run: rows left in the logs by a previous
            # run would silently duplicate into the merged export — start
            # every stream's log clean
            rlogs = _open_logs()
            for rl in rlogs:
                rl.truncate(0)

        if start_frame >= total:
            rows_by_stream = finish()
            return rows_by_stream, merge_stream_rows(rows_by_stream, with_stream=True)
        sources = [v[start_frame:] if start_frame else v for v in videos]
        stagers = self._stagers(sources)
        iters = [iter(st) for st in stagers]

        def consume(rec, n):
            # drainer thread: per-stream row collection in step order
            # (strict errors re-raise at the next submit/flush/close)
            ov = np.asarray(rec["stats_overflow"])[:, :n]
            bad = int((ov > 0).sum())
            if bad:
                self.overflow_frames += bad
                msg = (f"per-stream stats/reconcile capacity overflow on {bad} frame(s) "
                       f"(max {int(ov.max())} dropped): raise compact_slots/max_components "
                       "for this workload")
                if self.strict:
                    raise RuntimeError(msg)
                warnings.warn(msg)
            rows, valid, sums = rec["rows"], rec["row_valid"], rec["row_sums"]
            for s in range(rows.shape[0]):
                if use_log:
                    rlogs[s].append(collect_rows_array(rows[s, :n], valid[s, :n],
                                                       row_sums=sums[s, :n]))
                else:
                    rows_by_stream[s].extend(collect_rows(rows[s, :n], valid[s, :n],
                                                          row_sums=sums[s, :n]))

        # ~2048 frames a stream per drain group, as tpuva's
        drainer = AsyncRowDrainer(consume, group=max(2, 2048 // cfg.batch),
                                  max_groups_in_flight=1)
        steps = 0
        last_n = cfg.batch
        try:
            while True:
                items = []
                done = 0
                for it in iters:
                    try:
                        items.append(next(it))
                    except StopIteration:
                        done += 1
                if done:
                    if done != S:
                        raise RuntimeError("streams finished out of lock-step")
                    break
                ns = {n for n, _ in items}
                if len(ns) != 1:
                    raise RuntimeError(f"unequal tail batches: {ns}")
                n = ns.pop()
                carry, out = self._fn(carry, [b for _, b in items])
                drainer.submit(out, n)
                last_n = n
                steps += 1
                self.logger.log(n * S, queue=max(st.depth for st in stagers))
                if self.checkpoint_path and steps % self.checkpoint_every == 0:
                    drainer.flush()
                    if use_log:
                        for rl in rlogs:
                            rl.flush()
                    self._save_checkpoint(carry, rows_state(), cfg)
            drainer.close()
            # the padded-tail rule of StreamingPipeline: never persist a
            # carry perturbed by pad frames
            if self.checkpoint_path and last_n == cfg.batch:
                if use_log:
                    for rl in rlogs:
                        rl.flush()
                self._save_checkpoint(carry, rows_state(), cfg)
        except BaseException:
            drainer.kill()  # never leave the thread racing a resumed run's rows
            if use_log:
                for rl in rlogs:
                    rl.close()
            raise
        finally:
            for st in stagers:
                st.close()

        rows_by_stream = finish()
        merged = merge_stream_rows(rows_by_stream, with_stream=True)
        if export_dir:
            from tpuva_torch.export.hdf5io import write_multistream_hdf5, write_tracks_hdf5

            os.makedirs(export_dir, exist_ok=True)
            for s, rows in enumerate(rows_by_stream):
                write_tracks_hdf5(os.path.join(export_dir, f"stream_{s}.h5"), rows)
            write_multistream_hdf5(os.path.join(export_dir, "merged.h5"), merged)
        return rows_by_stream, merged

    def _save_checkpoint(self, carry, rows_state, cfg):
        """Seam for fault-injection tests; checkpoints the stacked carry
        plus the rows drained so far (embedded lists, or per-stream
        durable RowLog counts in row-log mode)."""
        save_multistream_checkpoint(self.checkpoint_path, carry, rows_state, cfg)
