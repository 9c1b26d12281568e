"""Streamed long-video processing with checkpoint/resume — port of
``tpuva/graph/streaming.py``.

``StreamingPipeline.run`` drives a video of any length through the batched
pipeline: ``BatchStager`` stages padded batches on the device (pinned
buffers, a side stream), each batch goes through ``process_batch`` (or the
staged route), and ``AsyncRowDrainer`` copies the small row outputs back
and collects them on a thread of its own. The carry (background, track
table, frame index — all the sequential state there is) stays on the
device and is checkpointed every K batches, so a long job resumes at batch
granularity: restore the carry, seek the video, continue. Checkpoints are
npz files with the same fields and dtypes as tpuva's, so a checkpoint
written by either package resumes in the other.

``row_log_path`` streams rows to an append-only ``RowLog`` file instead of
host memory; checkpoints then store only the durable row count.

The placement hook ``_place_carry`` is tpuva's:
``dist.pipeline.SpatialStreamPipeline`` overrides it to band the carry
across its mesh (its frames need no hook: the stager stages them on the
mesh's first device, where each band takes its rows).

Not carried over: tpuva's ``jax.transfer_guard`` around the hot loop (it
has no torch counterpart; the tracker still reads the device once per
frame, ROADMAP.md) and the drainer's packing of int32 sums into float32
halves (a TPU transport workaround).
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
import warnings
from typing import Optional

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.graph.pipeline import (
    PipelineCarry,
    _can_stage,
    carry_from_numpy,
    carry_to_numpy,
    collect_rows_array,
    init_carry,
    process_batch,
    process_batch_staged,
)
from tpuva_torch.io.base import VideoBase
from tpuva_torch.io.staging import BatchStager
from tpuva_torch.track.table import TrackState
from tpuva_torch.utils import BatchLogger


class RowLog:
    """Append-only binary trajectory-row store: float64 (k, 5) records of
    (track_id, frame, x, y, area) — copy of tpuva's RowLog.

    Drained rows are appended once and a checkpoint stores only the
    durable row count; resume truncates the log back to that count
    (discarding rows written after the snapshot), keeping checkpoint IO
    O(new rows) and host memory O(batch)."""

    RECORD = 5 * 8  # five float64 columns

    def __init__(self, path: str):
        self.path = path
        # create if missing, keep existing contents (resume truncates)
        self._fh = open(path, "ab")

    def append(self, arr: np.ndarray) -> None:
        a = np.ascontiguousarray(np.asarray(arr, np.float64).reshape(-1, 5))
        self._fh.write(a.tobytes())

    def flush(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def count(self) -> int:
        self._fh.flush()
        return os.path.getsize(self.path) // self.RECORD

    def truncate(self, n_rows: int) -> None:
        self._fh.flush()
        self._fh.truncate(n_rows * self.RECORD)

    def read(self) -> np.ndarray:
        self._fh.flush()
        data = np.fromfile(self.path, dtype=np.float64)
        return data.reshape(-1, 5)

    def close(self) -> None:
        self._fh.close()


def _to_host(x):
    """Start a copy of a tensor (or bool) to the host; returns the host
    tensor, complete once the current stream has passed the copy."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(x)
    if x.device.type == "cuda":
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        return h
    return x.detach().clone()


class AsyncRowDrainer:
    """Overlapped collection of device outputs: copy each batch's small
    trajectory fields to pinned host buffers without blocking, hand groups
    of batches to a consumer thread, which waits for their copies and
    passes the decoded per-batch records to a `consume` callback in
    submission order.

    `consume(rec, n)` receives a dict of numpy arrays — "rows"
    (*batch_shape, 5) float32, "row_valid" batch_shape bool, "row_sums"
    (*batch_shape, 2) int32, "active_tracks" int, plus "stats_overflow"
    batch_shape[:-1] int32 and "ccl_converged" bool when the producer
    emitted them — and the batch's valid frame count n along the frame
    axis (a padded tail batch has n < N; the consumer slices). It runs on
    the drainer thread.

    The bounded group queue doubles as backpressure: submit() blocks while
    `max_groups_in_flight` groups are waiting, so the producer runs at most
    that many groups (plus the one it fills) ahead of the consumer.

    Consumer-thread exceptions (e.g. a strict-mode overflow error raised
    by `consume`) are re-raised at the next submit()/flush()/close()."""

    FIELDS = ("rows", "row_valid", "row_sums", "stats_overflow", "ccl_converged",
              "active_tracks")

    def __init__(self, consume, group: int = 4, max_groups_in_flight: int = 1):
        self._consume = consume
        self._group = max(1, int(group))
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(max_groups_in_flight)))
        self._cur: list = []  # (n, host fields, copy event or None)
        self._dead = False
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="tpuva-row-drainer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer
    def submit(self, out: dict, n: Optional[int] = None) -> None:
        """Queue one batch's output dict (only the small trajectory fields
        are touched — masks etc. are ignored). n is the batch's valid frame
        count (None = all)."""
        self._raise_pending()
        host = {k: _to_host(out[k]) for k in self.FIELDS if k in out}
        event = None
        if out["rows"].device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(out["rows"].device))
        if n is None:
            n = out["rows"].shape[-3]  # frame axis extent
        self._cur.append((int(n), host, event))
        if len(self._cur) >= self._group:
            self._q.put(self._cur)
            self._cur = []

    def flush(self) -> None:
        """Block until every submitted batch has been decoded and handed to
        the sink (call before checkpointing on the sink's state)."""
        if self._cur:
            self._q.put(self._cur)
            self._cur = []
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join()
        self._raise_pending()

    def kill(self) -> None:
        """Abandon all queued work WITHOUT handing it to the sink and stop
        the thread — for paths that reopen the same sink after an abort
        (it must not race the resumed run's log writes)."""
        self._dead = True
        self._cur = []
        self._q.put(None)  # consumer drops groups when dead, unblocks fast
        self._thread.join()

    # ------------------------------------------------------------ consumer
    def _run(self) -> None:
        while True:
            grp = self._q.get()
            if grp is None:
                self._q.task_done()
                return
            try:
                if self._exc is None and not self._dead:
                    self._decode(grp)
            except BaseException as e:  # noqa: BLE001 - surfaced at the next producer call
                self._exc = e
            finally:
                self._q.task_done()

    def _decode(self, grp: list) -> None:
        for _n, _host, event in grp:
            if event is not None:
                event.synchronize()
        for n, host, _event in grp:
            rec = {
                "rows": host["rows"].numpy(),
                "row_valid": host["row_valid"].numpy(),
                "row_sums": host["row_sums"].numpy(),
                "active_tracks": int(host["active_tracks"].sum()) if "active_tracks" in host else 0,
            }
            if "stats_overflow" in host:
                rec["stats_overflow"] = host["stats_overflow"].numpy()
            if "ccl_converged" in host:
                rec["ccl_converged"] = bool(host["ccl_converged"].all())
            self._consume(rec, n)

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _carry_payload(carry: PipelineCarry, cfg) -> dict:
    """The carry's fields and the config under tpuva's npz keys (a stream
    axis, where the carry has one, leads every field)."""
    c = carry_to_numpy(carry)
    return {
        "bg": c.bg,
        "bg_valid": c.bg_valid,
        "frame_idx": c.frame_idx,
        "track_pos": c.track.pos,
        "track_tid": c.track.tid,
        "track_missed": c.track.missed,
        "track_active": c.track.active,
        "track_next_id": c.track.next_id,
        "config_json": np.frombuffer(cfg.to_json().encode(), dtype=np.uint8),
    }


def _atomic_savez(path: str, payload: dict) -> None:
    """np.savez to a temporary file beside path, then renamed over it."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_carry(z, cfg, device) -> PipelineCarry:
    """The carry of an open checkpoint on `device`, after checking that it
    was written with cfg (compared as type(cfg), so either package's
    config class works)."""
    if type(cfg).from_json(bytes(z["config_json"]).decode()) != cfg:
        raise ValueError("checkpoint was produced with a different PipelineConfig")
    return carry_from_numpy(PipelineCarry(
        bg=z["bg"],
        bg_valid=z["bg_valid"],
        track=TrackState(
            pos=z["track_pos"],
            tid=z["track_tid"],
            missed=z["track_missed"],
            active=z["track_active"],
            next_id=z["track_next_id"],
        ),
        frame_idx=z["frame_idx"],
    ), device)


def save_checkpoint(path: str, carry: PipelineCarry, rows, cfg) -> None:
    """Atomic snapshot of the carry + rows so far (npz), with tpuva's
    fields and dtypes.

    rows: list of tuples or (k, 5) ndarray — embedded in the snapshot;
    or an int — the durable row COUNT of an external RowLog (the
    append-only mode; the snapshot then stays O(carry))."""
    payload = _carry_payload(carry, cfg)
    if isinstance(rows, (int, np.integer)):
        payload["row_count"] = np.int64(rows)
    else:
        payload["rows"] = np.asarray(rows, np.float64).reshape(-1, 5)
    _atomic_savez(path, payload)


def load_checkpoint(path: str, cfg, device="cuda"):
    """Returns (carry on `device`, rows) or raises. Validates that the
    config matches (compared as type(cfg), so either package's config
    class works).

    rows is a list of tuples (embedded-rows snapshots) or an int row
    count (append-only RowLog snapshots — truncate the log to it)."""
    with np.load(path) as z:
        carry = _load_carry(z, cfg, device)
        if "row_count" in z:
            return carry, int(z["row_count"])
        return carry, [tuple(r) for r in z["rows"]]


def _as_tuples(chunks: list) -> list:
    """(k, 5) float64 arrays -> (int, int, float, float, float) row tuples."""
    return [
        (int(r[0]), int(r[1]), float(r[2]), float(r[3]), float(r[4]))
        for arr in chunks
        for r in arr
    ]


class StreamingPipeline:
    """Drive a video of any length through the batched pipeline on
    `device` (the card unless device="cpu").

    - staging -> device compute -> row draining, overlapped
    - the carry stays on the device between batches
    - optional periodic checkpointing + resume
    - structured per-batch progress logging (fps, queue depth, tracks)

    Each batch takes process_batch (the one-dispatch route: K3, and K1
    with use_pallas), or process_batch_staged (K1 + K2) when use_pallas,
    a config the staged route covers and a CUDA device (or force_staged)
    come together — tpuva's dispatch. Otsu configs take either route (K4
    for the per-frame histograms); ccl_single_pass makes process_batch
    take K2 for its stats (graph/pipeline.py).

    parallel_bg defaults to False: the scanned background reorders float
    work and is not bit-identical to the sequential/refimpl ordering, so
    byte-identical exports hold only on the default path.

    Capacity violations are surfaced, not swallowed: stats overflow and
    CCL non-convergence raise when strict=True (default) and warn + count
    otherwise (.overflow_frames / .ccl_unconverged_batches).

    row_log_path enables the append-only unbounded-stream mode: drained
    rows stream to a RowLog file instead of host memory, checkpoints store
    only the durable row count, and run() returns the (k, 5) float64 row
    array read back from the log.
    """

    def __init__(
        self,
        cfg,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 50,  # batches
        parallel_bg: bool = False,
        max_components: int = 64,
        queue_depth: int = 3,
        log: bool = False,
        use_pallas: bool = False,
        sparse_strips: int = 256,
        compact_slots: int = 48,
        strict: bool = True,
        row_log_path: Optional[str] = None,
        ccl_single_pass: bool = False,
        force_staged: bool = False,
        device="cuda",
    ):
        self.cfg = cfg
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.parallel_bg = parallel_bg
        self.max_components = max_components
        self.queue_depth = queue_depth
        self.use_pallas = use_pallas
        # tpuva's TPU stats capacities, passed on as tpuva passes them; K2
        # and the dense stats have no capacity, so they change nothing
        self.sparse_strips = sparse_strips
        self.compact_slots = compact_slots
        self.ccl_single_pass = ccl_single_pass
        self.strict = strict
        self.row_log_path = row_log_path
        # take the staged route on the CPU too (its plain versions), so
        # that its plumbing is testable without a card
        self.force_staged = force_staged
        self.device = resolve_device(device)
        self.overflow_frames = 0
        self.ccl_unconverged_batches = 0
        self.active_tracks = 0  # last drained end-of-batch count
        self.logger = BatchLogger(enabled=log)

    def _place_carry(self, carry: PipelineCarry) -> PipelineCarry:
        """The carry as the step takes it (a subclass places it on its
        devices, as tpuva's mesh pipelines do); here as it is."""
        return carry

    def _make_stager(self, source):
        return BatchStager(source, self.cfg.batch, queue_depth=self.queue_depth,
                           device=self.device)

    def _step(self, cfg, carry, batch):
        if (
            self.use_pallas
            and _can_stage(cfg)
            and (self.device.type == "cuda" or self.force_staged)
        ):
            return process_batch_staged(cfg, carry, batch, max_components=self.max_components,
                                        sparse_strips=self.sparse_strips,
                                        compact_slots=self.compact_slots,
                                        ccl_single_pass=self.ccl_single_pass)
        return process_batch(
            cfg, carry, batch, parallel_bg=self.parallel_bg,
            max_components=self.max_components, use_pallas=self.use_pallas,
            ccl_single_pass=self.ccl_single_pass, compact_slots=self.compact_slots,
        )

    def warmup(self, H: int, W: int) -> None:
        """Build the kernels run() will launch for (H, W) frames and run one
        throwaway batch of zero frames through them, then wait for it — no
        pipeline state is touched. The first kernel call otherwise builds
        the library with nvcc in the middle of the stream."""
        cfg = self.cfg
        carry = self._place_carry(init_carry(cfg, H, W, device=self.device))
        frames = torch.zeros((cfg.batch, H, W), dtype=torch.uint8, device=self.device)
        _carry, out = self._step(cfg, carry, frames)
        out["rows"].cpu()

    def run(self, video: VideoBase, background0: Optional[np.ndarray] = None,
            resume: bool = True):
        """Process the whole video; returns trajectory rows — a list of
        (tid, frame, x, y, area) tuples, or a (k, 5) float64 array in
        row_log mode. If a checkpoint exists (and resume=True), continues
        from it."""
        cfg = self.cfg
        W, H = video.size
        chunks: list = []  # (k, 5) float64 arrays
        rlog: Optional[RowLog] = None  # opened only after mode validation
        carry = self._place_carry(init_carry(cfg, H, W, background0, device=self.device))
        start_frame = 0
        if resume and self.checkpoint_path and os.path.exists(self.checkpoint_path):
            carry, saved = load_checkpoint(self.checkpoint_path, cfg, self.device)
            carry = self._place_carry(carry)
            if isinstance(saved, int):
                if not self.row_log_path:
                    raise ValueError("checkpoint stores a RowLog count but no row_log_path was given")
                rlog = RowLog(self.row_log_path)
                rlog.truncate(saved)
            else:
                if self.row_log_path:
                    raise ValueError("checkpoint embeds rows but row_log_path is set")
                chunks = [np.asarray(saved, np.float64).reshape(-1, 5)]
            start_frame = int(carry.frame_idx)
        if self.row_log_path and rlog is None:
            # fresh (non-resume) run: rows left in the log by a previous run
            # would silently duplicate into this run's results
            rlog = RowLog(self.row_log_path)
            rlog.truncate(0)

        def rows_state():
            if rlog is not None:
                return rlog.count()
            return np.concatenate(chunks, axis=0) if chunks else np.zeros((0, 5))

        total = video.frame_count
        if start_frame >= total:
            if rlog is not None:
                out = rlog.read()
                rlog.close()
                return out
            return _as_tuples(chunks)
        source = video[start_frame:] if start_frame else video
        stager = self._make_stager(source)

        def consume(rec, n):
            # runs on the drainer thread, in submission order
            self._check_capacity(rec, n)
            self.active_tracks = int(rec["active_tracks"])
            arr = collect_rows_array(
                rec["rows"][:n], rec["row_valid"][:n], row_sums=rec["row_sums"][:n],
            )
            if rlog is not None:
                rlog.append(arr)
            else:
                chunks.append(arr)

        # ~2048 frames per drain group, as tpuva's
        drainer = AsyncRowDrainer(consume, group=max(2, 2048 // cfg.batch),
                                  max_groups_in_flight=1)
        batches_done = 0
        last_n = cfg.batch
        try:
            for n, batch in stager:
                carry, out = self._step(cfg, carry, batch)
                drainer.submit(out, n)
                last_n = n
                batches_done += 1
                self.logger.log(n, queue=stager.depth, tracks=self.active_tracks)
                if self.checkpoint_path and batches_done % self.checkpoint_every == 0:
                    drainer.flush()
                    if rlog is not None:
                        rlog.flush()
                    save_checkpoint(self.checkpoint_path, carry, rows_state(), cfg)
            drainer.close()
            # a padded tail batch perturbs the carry past the stream end
            # (repeated pad frames enter the background model / tracker):
            # persisting it would poison a resume against a later-appended
            # video, so the final checkpoint is skipped in that case and
            # the last periodic checkpoint remains authoritative.
            if self.checkpoint_path and last_n == cfg.batch:
                if rlog is not None:
                    rlog.flush()
                save_checkpoint(self.checkpoint_path, carry, rows_state(), cfg)
        except BaseException:
            drainer.kill()  # do not leave the thread racing the sink: a
            if rlog is not None:  # resumed run may reopen the same RowLog
                rlog.close()
            raise
        finally:
            stager.close()
        if rlog is not None:
            out = rlog.read()
            rlog.close()
            return out
        return _as_tuples(chunks)

    def _overflow_message(self, bad: int, most: int) -> str:
        return (f"stats capacity overflow on {bad} frame(s) (max {most} "
                "dropped): areas/centroids are inexact for those frames")

    def _check_capacity(self, out: dict, n: int) -> None:
        """Surface silent-accuracy-loss conditions (stats overflow, a CCL
        that did not converge)."""
        if "stats_overflow" in out:
            ov = np.asarray(out["stats_overflow"][:n])
            bad = int((ov > 0).sum())
            if bad:
                self.overflow_frames += bad
                msg = self._overflow_message(bad, int(ov.max()))
                if self.strict:
                    raise RuntimeError(msg)
                warnings.warn(msg)
        if "ccl_converged" in out and not bool(np.asarray(out["ccl_converged"])):
            self.ccl_unconverged_batches += 1
            msg = "CCL did not converge — labels may be split for this batch"
            if self.strict:
                raise RuntimeError(msg)
            warnings.warn(msg)
