"""BASELINE config 4 at the scale the baseline states, on the card: the
port's counterpart of ``bench/soak_100k.py``. A 100k+ frame 1080p run
through the staged route (``process_batch_staged``: K1, K2, K5) with the
rolling background, append-only row output (``RowLog``), checkpoints, a
kill and a resume, bounded host memory and a float64 background-drift
oracle.

Frames are rendered on the card by an integer-math scene
(``make_render_torch``), so the soak measures the pipeline, not the host's
staging. The same scene in NumPy (``render_frames_np``) feeds the oracles:
the float32 background on the card is compared with an exact float64
recurrence over every update on a 64 x 64 interior crop, and the rows'
centroids with the scene's analytic blob centres.

    python -m tpuva_torch.probes.soak_100k [--frames N] [--workdir DIR] [--device cpu]

Checks (``soak`` raises on the first three):
  1. bounded memory: the RSS, sampled every RSS_EVERY batches, grows
     less than RSS_SLACK_MB over the second half of the run;
  2. kill and resume: a second run is aborted after half its batches,
     resumed from its last checkpoint and finished; its RowLog file and
     its CSV are byte-identical to the uninterrupted run's (the HDF5 of
     the JAX file needs h5py, which the card lacks);
  3. the median distance of sampled rows to the nearest analytic centre
     is below 1 px;
  4. the drift: max |float32 background - float64 recurrence| on the crop
     (reported), and the sha256 of the CSV of the rows of the first
     PREFIX_FRAMES frames (rows are causal: the caller holds it to the OpenCV
     reference on those frames alone).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.export.csvio import format_rows
from tpuva_torch.graph import config as C
from tpuva_torch.graph.pipeline import collect_rows_array, init_carry, process_batch_staged
from tpuva_torch.graph.streaming import AsyncRowDrainer, RowLog, load_checkpoint, save_checkpoint
from tpuva_torch.ops.filters import gaussian_blur_u8

# the scene: a plate texture and bouncing disks, int32 arithmetic only, so
# that the card's frames and the host oracle's are the same bytes
N_BLOBS = 6
AMP = 120
RADIUS = 16
RSS_EVERY = 16  # batches between RSS samples
PREFIX_FRAMES = 2048  # the frames whose rows' CSV sha256 soak reports


def _blob_params(H, W, i):
    x0 = 37 + 211 * i
    y0 = 53 + 173 * i
    vx = 2 + (i % 3)
    vy = 1 + (i % 4)
    return x0, y0, vx, vy


def render_frames_np(H, W, t0, n, region=None):
    """(n, h, w) uint8, frames t0..t0+n-1 — the host-side oracle twin.

    region=(ys, xs, h, w) renders only that window (blob positions are
    global, the per-pixel math restricts to the window) — the drift
    oracle would otherwise rasterize 100k full 1080p frames in NumPy."""
    ys, xs, h, w = region if region else (0, 0, H, W)
    y = (np.arange(h, dtype=np.int64) + ys)[None, :, None]
    x = (np.arange(w, dtype=np.int64) + xs)[None, None, :]
    plate = ((x * 7 + y * 13) % 23 + 40).astype(np.int64)
    t = np.arange(t0, t0 + n, dtype=np.int64)[:, None, None]
    acc = np.broadcast_to(plate, (n, h, w)).copy()
    Mx, My = W - 2 * RADIUS, H - 2 * RADIUS
    for i in range(N_BLOBS):
        x0, y0, vx, vy = _blob_params(H, W, i)
        mx = (x0 + vx * t) % (2 * Mx)
        cx = np.minimum(mx, 2 * Mx - mx) + RADIUS
        my = (y0 + vy * t) % (2 * My)
        cy = np.minimum(my, 2 * My - my) + RADIUS
        d2 = (x - cx) ** 2 + (y - cy) ** 2
        acc = np.where(d2 <= RADIUS * RADIUS, plate + AMP, acc)
    return np.clip(acc, 0, 255).astype(np.uint8)


def make_render_torch(H, W, n, device="cuda"):
    """render(t0) -> (n, H, W) uint8 tensor on `device`: frames t0..t0+n-1
    of the scene, render_frames_np's bytes. Each frame is the plate with
    every disk's pixels (the offsets within RADIUS of its centre) set to
    plate + AMP: one scatter of n x N_BLOBS disks, not a distance a pixel
    and a blob. A centre lies in [RADIUS, H - RADIUS] x [RADIUS, W -
    RADIUS], so a disk leaves the frame only by its last row or column
    (row H or column W); those writes go to a spare byte past the frames."""
    dev = resolve_device(device)
    y = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    plate = (x * 7 + y * 13) % 23 + 40
    plate_u8 = plate.clamp(0, 255).to(torch.uint8)
    fg = (plate + AMP).clamp(0, 255).to(torch.uint8).reshape(-1)
    d = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.int32, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    inside = dy * dy + dx * dx <= RADIUS * RADIUS
    dy, dx = dy[inside], dx[inside]  # the disk's offsets, (K,)
    frame = torch.arange(n, dtype=torch.int32, device=dev)
    spare = n * H * W
    x0, y0, vx, vy = torch.tensor([_blob_params(H, W, i) for i in range(N_BLOBS)],
                                  dtype=torch.int32, device=dev).T
    Mx, My = W - 2 * RADIUS, H - 2 * RADIUS

    def render(t0):
        # the centres at frames t (n, N_BLOBS): triangle waves of period
        # 2 M, every % of a non-negative value
        t = (int(t0) + frame)[:, None]
        mx = (x0 + vx * t) % (2 * Mx)
        my = (y0 + vy * t) % (2 * My)
        cx = torch.minimum(mx, 2 * Mx - mx) + RADIUS
        cy = torch.minimum(my, 2 * My - my) + RADIUS
        ys = cy[..., None] + dy  # (n, N_BLOBS, K)
        xs = cx[..., None] + dx
        keep = (ys < H) & (xs < W)
        px = torch.where(keep, ys * W + xs, 0).to(torch.int64)
        idx = torch.where(keep, frame[:, None, None].to(torch.int64) * (H * W) + px, spare)
        buf = torch.empty(spare + 1, dtype=torch.uint8, device=dev)
        buf[:spare].view(n, H, W).copy_(plate_u8.expand(n, H, W))
        # overlapping disks write the same byte, plate + AMP, at a pixel
        buf.index_put_((idx.reshape(-1),), fg[px.reshape(-1)])
        return buf[:spare].view(n, H, W)

    return render


def rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


# BASELINE config 4: 100k+ 1080p frames, batches of 256; the JAX file's
# bound on RSS growth over the second half
FRAMES = 100_352
H, W, BATCH = 1080, 1920, 256
RSS_SLACK_MB = 512.0
CALIB_ITERS = 8  # calibrate_stage_split's batches


def build_cfg(batch=BATCH):
    """The soak's config, the JAX file's: blur 5, open 3 rect, threshold
    60, Hungarian, 16 tracks."""
    return C.PipelineConfig(
        background=C.BackgroundConfig(alpha=0.02),
        blur=C.BlurConfig(ksize=5, sigma=0.0),
        morph_open=C.MorphConfig(ksize=3, shape="rect"),
        segment=C.SegmentConfig(threshold=60.0, min_area=50, max_blobs=8),
        track=C.TrackConfig(max_dist=80.0, death_patience=5, max_tracks=16,
                            assigner="hungarian"),
        batch=batch,
    )


class Abort(Exception):
    pass


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_soak(cfg, H, W, total_frames, ckpt_path, rowlog_path,
             abort_at_batch=None, resume=False, ckpt_every=256,
             rss_samples=None, timings=None, device="cuda"):
    """A run fed by the renderer on `device` through process_batch_staged,
    with periodic append-only checkpoints (RowLog + the carry). Returns
    (rowlog, carry).

    Rows ride an AsyncRowDrainer (one group of 2048 frames' outputs at a
    time, decoded off-thread), so the loop blocks only on the drainer's
    backpressure and on checkpoint flushes. Every ckpt_every batches the
    drainer is flushed and the checkpoint written; every RSS_EVERY batches
    (frames done, RSS MB) is appended to rss_samples. abort_at_batch raises
    Abort after that many batches. timings (dict) gets the host seconds of
    dispatch, flushes and checkpoints, and the active tracks at the end."""
    dev = resolve_device(device)
    N = cfg.batch
    render = make_render_torch(H, W, N, dev)
    carry = init_carry(cfg, H, W, device=dev)
    rlog = RowLog(rowlog_path)
    start = 0
    if resume and os.path.exists(ckpt_path):
        carry, saved = load_checkpoint(ckpt_path, cfg, dev)
        rlog.truncate(int(saved))
        start = int(carry.frame_idx)
    else:
        rlog.truncate(0)
    batches = (total_frames - start) // N
    tm = timings if timings is not None else {}
    for k in ("dispatch_s", "flush_s", "ckpt_s"):
        tm.setdefault(k, 0.0)

    def consume(rec, n):
        ov = rec.get("stats_overflow")
        if ov is not None and int(ov.max()) != 0:
            raise RuntimeError("component stats overflow in the soak")
        rlog.append(collect_rows_array(rec["rows"], rec["row_valid"], row_sums=rec["row_sums"]))

    # ~2048 frames a drain group (group 8 at batch 256), as the JAX file
    drainer = AsyncRowDrainer(consume, group=max(2, 2048 // N), max_groups_in_flight=1)
    try:
        for b in range(batches):
            td = time.perf_counter()
            t0 = start + b * N
            carry, out = process_batch_staged(cfg, carry, render(t0))
            tm["dispatch_s"] += time.perf_counter() - td
            drainer.submit(out)
            done = b + 1
            if done % ckpt_every == 0:
                tf = time.perf_counter()
                drainer.flush()
                tm["flush_s"] += time.perf_counter() - tf
                tc = time.perf_counter()
                _sync(dev)
                rlog.flush()
                save_checkpoint(ckpt_path, carry, rlog.count(), cfg)
                tm["ckpt_s"] += time.perf_counter() - tc
            if rss_samples is not None and done % RSS_EVERY == 0:
                rss_samples.append((t0 + N, rss_mb()))
            if abort_at_batch is not None and done >= abort_at_batch:
                raise Abort()
        drainer.close()
    except BaseException:
        drainer.kill()  # a real kill takes the thread down with the
        raise           # process; it must not race the resumed run
    finally:
        tm["active_tracks"] = int(carry.track.active.sum())
    return rlog, carry


def warmup(cfg, H, W, device="cuda"):
    """One batch through the soak's programs on a throwaway carry, so the
    timed run starts with every kernel built and loaded."""
    dev = resolve_device(device)
    render = make_render_torch(H, W, cfg.batch, dev)
    _c, out = process_batch_staged(cfg, init_carry(cfg, H, W, device=dev), render(0))
    out["rows"].cpu()


def centroid_oracle_err(flat_rows, H, W, sample=4096, seed=0):
    """Median distance from sampled trajectory rows to the NEAREST
    analytic blob center at that frame. The renderer's centers are exact
    integer math, and a rasterized disk's centroid sits within ~0.5 px of
    its center, so a healthy run medians well under 1 px. Guards the whole
    row path end-to-end (stats sums -> drain -> RowLog): a transport bug
    that zeroes or misaligns centroids blows this up to O(image size).
    Median, not max: transient blob overlaps merge components whose joint
    centroid is legitimately far from either center."""
    flat = np.asarray(flat_rows, np.float64).reshape(-1, 5)
    if not len(flat):
        return float("nan")
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(flat), size=min(sample, len(flat)), replace=False)
    t = flat[pick, 1].astype(np.int64)[:, None]  # frame
    xy = flat[pick, 2:4]
    Mx, My = W - 2 * RADIUS, H - 2 * RADIUS
    cx = np.empty((len(pick), N_BLOBS)); cy = np.empty_like(cx)
    for i in range(N_BLOBS):
        x0, y0, vx, vy = _blob_params(H, W, i)
        mx = (x0 + vx * t[:, 0]) % (2 * Mx)
        cx[:, i] = np.minimum(mx, 2 * Mx - mx) + RADIUS
        my = (y0 + vy * t[:, 0]) % (2 * My)
        cy[:, i] = np.minimum(my, 2 * My - my) + RADIUS
    d = np.sqrt((xy[:, 0:1] - cx) ** 2 + (xy[:, 1:2] - cy) ** 2).min(axis=1)
    return float(np.median(d))


def drift_oracle(cfg, H, W, T, bg, crop=64, chunk=512):
    """max |bg - bg64| on a crop x crop interior window at (H // 3, W // 3):
    bg64 is the background recurrence in float64 over frames 0..T-1 of the
    scene, blurred so that it sees the frames the card's recurrence sees,
    so what remains is float32 against float64 accumulation. The blur is
    the port's own gaussian_blur_u8 standing in for the JAX file's
    cv2.GaussianBlur (the card has no cv2), so the recurrence is not
    independent of the blur under test; the CPU tests hold that blur to
    cv2's on the crop. The drift is reported, not gated."""
    y0, x0, M = H // 3, W // 3, 4  # the crop and a margin past the blur's reach
    a = np.float64(cfg.background.alpha)
    bg64 = None
    for t in range(0, T, chunk):
        frames = torch.from_numpy(render_frames_np(
            H, W, t, min(chunk, T - t), region=(y0 - M, x0 - M, crop + 2 * M, crop + 2 * M)))
        if cfg.blur is not None:
            frames = gaussian_blur_u8(frames, cfg.blur.ksize, cfg.blur.sigma)
        frames = frames[:, M:-M, M:-M].to(torch.float64).numpy()
        for f in frames:
            bg64 = f.copy() if bg64 is None else (1.0 - a) * bg64 + a * f
    bg32 = bg[y0:y0 + crop, x0:x0 + crop].cpu().numpy().astype(np.float64)
    return float(np.abs(bg32 - bg64).max())


def calibrate_stage_split(cfg, H, W, iters=CALIB_ITERS, device="cuda"):
    """Synchronised medians of one batch's render and one staged pipeline
    step, after a soak (every kernel built): the loop overlaps both."""
    dev = resolve_device(device)
    N = cfg.batch
    render = make_render_torch(H, W, N, dev)
    carry = init_carry(cfg, H, W, device=dev)
    rts, sts = [], []
    for i in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        f = render(i * N)
        _sync(dev)
        rts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        carry, out = process_batch_staged(cfg, carry, f)
        out["rows"].cpu()
        sts.append(time.perf_counter() - t0)
    return {"render_ms_per_batch": float(np.median(rts)) * 1e3,
            "step_ms_per_batch": float(np.median(sts)) * 1e3}


def soak(frames=FRAMES, workdir=None, device="cuda"):
    """The JAX file's main on the port, at BASELINE config 4's H x W and
    BATCH: run A uninterrupted (timed, after a warm-up), run B killed at
    half its batches and resumed, the oracles. Returns the result dict,
    whose "steps" is the number of process_batch_staged calls it made;
    raises AssertionError if RSS grew RSS_SLACK_MB or more over run A's
    second half, if run B's RowLog or CSV differs from run A's, or if the
    centroid median is 1 px or more."""
    dev = resolve_device(device)
    batch = BATCH
    cfg = build_cfg(batch)
    T = (frames // batch) * batch
    nbatches = T // batch
    workdir = workdir or tempfile.mkdtemp(prefix="tpuva_soak_")
    os.makedirs(workdir, exist_ok=True)
    paths = {k: os.path.join(workdir, k) for k in ("a.npz", "a.rows", "b.npz", "b.rows")}
    for p in paths.values():
        if os.path.exists(p):
            os.unlink(p)

    # run A: uninterrupted, timed after the warm-up
    tw = time.perf_counter()
    warmup(cfg, H, W, dev)
    _sync(dev)
    warm_s = time.perf_counter() - tw
    rss, tm = [], {}
    t0 = time.perf_counter()
    log_a, carry_a = run_soak(cfg, H, W, T, paths["a.npz"], paths["a.rows"], rss_samples=rss,
                              timings=tm, device=dev)
    _sync(dev)
    run_s = time.perf_counter() - t0
    flat_a = log_a.read()
    half = len(rss) // 2
    rss_growth = rss[-1][1] - rss[half][1] if len(rss) >= 2 else 0.0
    if not rss_growth < RSS_SLACK_MB:
        raise AssertionError(f"soak: RSS grew {rss_growth} MB over the second half: {rss}")

    # run B: killed at half its batches, resumed from its last checkpoint;
    # checkpoints every 64 batches (fewer on a short run, so that one
    # falls before the kill and the resume truncates the log)
    ckpt_every_b = min(64, max(1, nbatches // 5))
    try:
        run_soak(cfg, H, W, T, paths["b.npz"], paths["b.rows"], abort_at_batch=nbatches // 2,
                 ckpt_every=ckpt_every_b, device=dev)
    except Abort:
        pass
    resumed_from = int(load_checkpoint(paths["b.npz"], cfg, "cpu")[0].frame_idx) \
        if os.path.exists(paths["b.npz"]) else 0
    log_b, carry_b = run_soak(cfg, H, W, T, paths["b.npz"], paths["b.rows"], resume=True,
                              ckpt_every=ckpt_every_b, device=dev)
    flat_b = log_b.read()
    for log in (log_a, log_b):
        log.close()
    with open(paths["a.rows"], "rb") as fa, open(paths["b.rows"], "rb") as fb:
        rows_identical = fa.read() == fb.read()
    csv_a = format_rows(flat_a).encode()
    csv_identical = csv_a == format_rows(flat_b).encode()
    if not (rows_identical and csv_identical):
        raise AssertionError("soak: the resumed run's rows differ from the uninterrupted run's")
    if not torch.equal(carry_a.bg, carry_b.bg):
        raise AssertionError("soak: the resumed run's background differs")

    drift = drift_oracle(cfg, H, W, T, carry_a.bg)
    cent_err = centroid_oracle_err(flat_a, H, W)
    if not cent_err < 1.0:
        raise AssertionError(f"soak: centroid oracle median {cent_err} px")
    prefix_rows = flat_a[flat_a[:, 1] < PREFIX_FRAMES]
    split = calibrate_stage_split(cfg, H, W, device=dev)
    return {
        "frames": T, "resolution": f"{H}x{W}", "batch": batch,
        "seconds": run_s, "fps": T / run_s, "rows": int(len(flat_a)),
        "track_ids": len(np.unique(flat_a[:, 0])),
        # the warm-up, run A, run B up to the kill and after the resume,
        # the calibration
        "steps": 1 + nbatches + nbatches // 2 + (T - resumed_from) // batch + CALIB_ITERS,
        "rss_mb_final": rss[-1][1] if rss else None,
        "rss_samples": len(rss), "rss_growth_2nd_half_mb": rss_growth,
        "killed_at_batch": nbatches // 2, "resumed_from_frame": resumed_from,
        "resume_rowlog_byte_identical": rows_identical,
        "resume_csv_byte_identical": csv_identical,
        "centroid_oracle_median_err_px": cent_err,
        "bg_drift_f32_vs_f64_max_abs": drift,
        "prefix_frames": PREFIX_FRAMES, "prefix_rows": int(len(prefix_rows)),
        "prefix_csv_sha256": hashlib.sha256(format_rows(prefix_rows).encode()).hexdigest(),
        "active_tracks_final": tm["active_tracks"],
        "warm_s": warm_s, "dispatch_s": tm["dispatch_s"], "flush_s": tm["flush_s"],
        "ckpt_s": tm["ckpt_s"], **split,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(soak(args.frames, args.workdir, args.device)), flush=True)


if __name__ == "__main__":
    main()
