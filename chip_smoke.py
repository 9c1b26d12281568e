#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpuva_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase below
    python3 chip_smoke.py --k1     # phases 1-3b, then K1's timings only
    python3 chip_smoke.py --k2     # phases 1-2, then K2's, K3's and K6's timings only
                                   # (CUDA events; device ms and launches a call)
    python3 chip_smoke.py --k5     # phases 1-2, then K5's timings only
    python3 chip_smoke.py --wide   # phases 1-2, then K1m's and K1b's timings only
    python3 chip_smoke.py --median # phases 1-2, then K7's checks, timings and SASS, and
                                   # phase 7g (the median route at 5 and 15) only (copied
                                   # into an earlier checkout: that checkout's K7)
    python3 chip_smoke.py --probes # phases 1-2, then phase 9 (the micro-probes) only
    python3 chip_smoke.py --staging # phases 1-2, then the staging line only (copied
                                    # into an earlier checkout: that checkout's stager)
    python3 chip_smoke.py --multistream # phases 1-2, then phase 7d (config 5) only
    python3 chip_smoke.py --filters # phases 1-2, then phase 7e (the filter chain) only
    python3 chip_smoke.py --spatial # phases 1-2, then phase 7f (the meshes of dist/) only
    python3 chip_smoke.py --configs # phases 1-2, then phase 7h (BASELINE configs 1-3, Otsu
                                    # at 480p, 4K UHD) only
    python3 chip_smoke.py --soak    # phases 1-2, then phase 7i (the soak) only
    python3 chip_smoke.py --scanned # phases 1-2, then phase 7j (the scanned background) only

Run from the repository root on a machine with one CUDA card and nvcc; it
builds the kernels into build/tpuva_torch/ first. It imports no JAX and
nothing of the JAX package. Each phase prints one line, and any failure
raises, so the exit code is non-zero:

1. card: nvidia-smi's name and power limit (on a line of their own), the
   torch and CUDA versions;
2. build: nvcc compiles tpuva_torch/csrc/*.cu (registers and spills of
   K1's, K1b's, K1m's, K7's, K2's, K3 4-connected's, K6's, K5's and the
   micro-probes' kernels in the build line); the host compiler builds
   csrc/batcher.cpp, the staging ring (build_host line);
3. K1 (fused_segment) against its plain version on the card, at
   (16, 1080, 1920), a ragged (5, 250, 333) and a one-column (4, 120, 1),
   over six configs (blur 3, 5, 7 and 9 taps: the unrolled and the
   generic instantiations): masks and background bit-equal;
3b. K1's emit="diff" against its plain version at the same shapes over
   three configs, and a tie case (alpha 0, bg0 = k + 0.5: every magnitude
   a .5 tie), magnitudes and background bit-equal; K4 (histogram_u8)
   against its plain version on those magnitudes and on random bytes;
3c. K1's padded_occ mode against its plain version: the padded mask (its
   zero padding included), occ128 and the background bit-equal at
   (16, 1080, 1920), a ragged (5, 250, 333) and on phase 5c's 160 x 240
   clip for the configs one K1 launch does not take (K1m's last step
   writing the padded mask and occ128 where the open and close leave K1);
3d. K7 (median_u8, the exact k x k median of uint8 frames) against its
   plain version (median_u8_plain) on the card, bit for bit: k = 3, 5, 7,
   11 and 15 on a (256, 1080, 1920) batch of the clip, 9 and 25 on phase
   5c's 160 x 240 clip, and 3 to 255 on random bytes of edge shapes (8 x
   300 and 300 x 8, H or W below the window; one row; one pixel; 5 x 7;
   40 x 70; 9 rows of the ragged widths 1, 2, 3, 5, 37), 435 and 437 on
   three of them; k = 3, 5, 7, 9, 11, 15 on 1080-row frames of those
   widths and of 1917, and on the adversarial frames at (2, 1080, 1920)
   (constant, two values, 0/255, ramps, outliers); against
   median_u8_counts_plain (memory that does not grow with k) k = 25, 51,
   255, 257 and 437 on two frames of the clip, two random frames with a
   dark half and the adversarial frames, all at 1080p: the network
   kernels (k <= 9) and the sliding histogram (k >= 11; 8-, 16- and 32-bit
   counts), the histogram tier forced at k = 7 and 9 against the
   networks, its plan on the card (count bytes, threads, strip, shared
   bytes, CTAs an SM) against ops/median.py::hist_plan; with the SASS of
   K7's min/max forms and kernels and the forms' rates (median_sass);
4. K2 (CCL + stats, one cooperative launch with its stats epilogue)
   against its plain version (label_sums_plain, then _assemble_stats) on
   the card, on K1's masks and random masks of density 0.05 and 0.3: every
   stats field bit-equal, overflow included;
   K2 given the strip occupancy (from K1's occ128 on K1's padded masks, of
   the mask padded to 64 x 256 on the random ones, and on an all-empty
   batch) against K2 deriving it and against the plain version;
5. K3 (dense root-key labels) against its plain version on the card, bit
   for bit, 8- and 4-connected, on the masks of phase 4, the U shape and
   mixed scene of tpuva_torch.scenes, odd sizes, the edge-strip scenes
   (one occupied strip at each ragged edge, components across tile and
   strip borders, every pixel, none) and the 4-connected segment scenes
   (conn4_scene: tile and strip borders, diagonal contacts across a tile
   corner, ragged H and W), each scene and connectivity with the strip
   occupancy K3 hands K6 equal to the labels'; then
   connected_components_with_stats (labels, bbox, every field) on the
   card against the CPU on a (2, 1080, 1920) batch, each connectivity one
   K3 and one K6 launch given K3's occupancy (the 4-connected run's K3
   launches are the kernels line's);
5a. K6 against its plain version on the card, bit for bit: the raw
   outputs (root_stats: count, sums, bbox extremes, dense ids) at every
   option (sums; with the bbox; with the ids; both; the ids alone, as
   relabel_dense) and the whole stats dict (root_stats_dict against
   root_stats_plain then _stats_dict: every key, the centroid's float bits,
   bbox and labels each way), on phase 5's labels, 8- and 4-connected,
   given K3's occupancy and deriving it, C = 1, 32, 2000 and 13000 (the
   global-memory paths) on the small scenes, 32 at 1080p;
   process_batch_staged(return_labels=True) launches K3 and K6 given K3's
   occupancy once, its ids equal to the plain version's;
5b. K5 (track_scan) against its plain version (on the CPU), bit for bit
   (rows, row_valid, every state tensor): on the route's own batch-256
   detections (the bench front end and K2 on the clip's two batches, the
   second from the state the first leaves) and on the synthetic streams of
   tpuva_torch.scenes.det_sequence (churn, empty, contested, crowd, cloud)
   at three table shapes, both assigners, frames near 2^24, and one table
   too large for shared memory (the global-scratch instantiation); each
   launch took the kernel scan_plan names (the register kernel up to
   32 x 32; 64 x 16 and 600 x 100 the kept table kernel, in shared memory
   and in global scratch);
5c. configs one K1 launch does not take (open and close 7 x 10, median 3
   with 5 x 10, a 33-wide close, a 65-tap blur, median 5, median 7 with
   Otsu) through process_clip on both use_pallas values and
   StreamingPipeline on the card: K1 a batch with K1b (blur_u8, one launch)
   or K1m (morph_u8, a launch a morph_plan group) where k1_split takes the
   blur or the morphology out of its launch; for a median k > 3 the
   median route, exactly one K1b, one K7 and one K1 launch a batch, no
   K1m for median 5 and the Otsu tail's morph_plan groups and one K4 for
   median 7 with Otsu; one K5 launch a batch, rows,
   masks and background equal to the CPU run; K1b and K1m against their
   plain versions on that path's frames and masks; then a 1080p batch of
   64 frames with median 7 through process_batch on the card (the median
   route), timed, its filtered frames (K1b, K7) equal to the CPU's;
6. the staged route: bench config at 1080p, batch 256, max_components 32,
   a 512-frame six-blob clip through process_clip(use_pallas=True) on
   cuda (K1 + K2 + K5), with the launch counts read around it; its CSV bytes
   equal the OpenCV reference's (REF_CSV_SHA256) and most rows lie within
   1 px of the clip's truth; K1 ran in padded_occ mode and K2 took its
   occupancy (the padded handoff at 1080p); a 48-frame sub-clip run on the
   CPU (plain versions) and on the card gives identical rows, masks,
   background and CSV bytes;
7. the streamed default route: the same clip through
   StreamingPipeline(cfg, max_components=32).run(VideoMemory(clip)) on
   cuda (front end K1, then K3 and K6 given K3's occupancy, K5), launch
   counts read around it: K1, K3, K6 (as often as K3, each given K3's
   occupancy) and K5 launched, K2 not, CSV sha256 == REF_CSV_SHA256;
   the same with
   use_pallas=True (K1 in padded_occ mode + K2 given its occupancy + K5,
   no K3); a run stopped after its first
   checkpointed batch and resumed on the whole clip gives the same bytes;
   K3 against its plain version on the route's own batch-256 masks;
7c. staging: the streamed default route fed by a decoder stand-in of
   the clip (frames only through get_frame), which BatchStager sends
   through its native feeder (the C++ ring of csrc/batcher.cpp), its CSV
   sha256 == REF_CSV_SHA256 and the route's launches; every batch both
   feeders stage on the card (a 300-frame clip: a full batch and a padded
   one, queue depth 1, a slow consumer) bit-equal to the CPU's; the route
   fed by a ParallelVideoReader of 4 workers over a callable that returns
   the clip's VideoMemory, through the ring too, the same sha256
   (process_clip, which stages through the Python feeder's pinned slots,
   is held to it in phase 6);
7b. the Otsu routes: the bench config with threshold="otsu" on the same
   clip through process_clip(use_pallas=True) (K1's diff emit, K4, K2
   deriving its occupancy; no K3, no padded K1) and the streamed default
   route (K1's diff emit, K4, K3, K6; no K2
   launch), K5 on both, the Otsu tail's open and close on K1m (exactly
   its morph_plan groups a batch), each run's CSV sha256 equal to
   REF_OTSU_CSV_SHA256; a 48-frame sub-clip on the CPU (plain versions)
   and on the card gives identical rows, masks and background;
7g. the median route at full width: the bench config with median 5 and
   with median 15 (K7's histogram tier) on the same clip through
   process_clip and StreamingPipeline (twice), each run's CSV sha256 equal
   to REF_MEDIAN5_CSV_SHA256 or REF_MEDIAN15_CSV_SHA256, K1b, K7, K1 and
   K5 exactly once a batch, no K1m and no torch morphology step (_morph
   counted around each run), each run's seconds and frames/s;
7d. config 5, the multistream path: MS_STREAMS (8) streams of the clip
   (stream 0 the clip in memory with its plate; stream s a decoder
   stand-in of it shifted by 64 s frames, its plate its own first frame),
   batch 256, through MultiStreamPipeline on cuda: K1 with the stream axis
   against its plain version on the card (8 streams x 16 frames, distinct
   plates, mask and diff emits, one seed flag and one a stream), K5 with
   the stream axis against its plain version (a det_sequence stream each,
   tables 16 x 8, 32 x 32 and 33 x 40); the run's launches (K1, K5, K3,
   K6 once a step, for all streams; no K2); stream 0's CSV sha256 ==
   REF_CSV_SHA256, every stream's rows equal the single-stream streamed
   default route on it, merged equal merge_stream_rows of those, a run
   stopped after its first step and resumed from its checkpoint equal to
   the straight one; then frames/s of all streams (an untimed run, two
   timed), one step's device ms on batches already on the card (its
   launches: one K1, one K5), K1 and K5 at 8 streams against 8
   single-stream launches (bit-equal first; each after an untimed run,
   5 repeats in turns, min-max), their plain versions, and staging: one
   stager alone and 8 at once (a consumer thread and CUDA stream each,
   in turns), ms a batch each and GB/s, the pinned bytes and the peak
   device memory of the run;
7e. the filter chain (tpuva_torch.filters): every filter at 1080p on 16
   frames, gray and BGR, on the card against the CPU, bit for bit (K1b once
   for FilterBlur on uint8, K7 once for FilterMedian on uint8, K1's diff
   emit once for FilterBackground, each against its plain version on
   those inputs), with its program's device
   ms; the EDT and its squared form on K1's masks against the CPU's (the
   passes of each stage, the ms; an all-foreground frame +inf) and
   analysis.regions.mask_boundary (one K1m launch, against its plain
   version and the CPU); the chain route: the clip as BGR of three equal
   channels through StreamingPipeline over FilterMonochrome on cuda, its
   CSV sha256 == REF_CSV_SHA256, K1, K3, K6, K5 and KM once a batch and the
   chain's program once a batch (BatchStager staging the BGR root and
   running the chain on the card), frames/s beside the gray route's (in
   turns), the stager's ms a batch of both and the chain program's device
   ms; a stateful chain, FilterBackground(FilterBlur(FilterMonochrome(
   VideoMemory(bgr)), 5), 0.02), through iter_batches(256): K1b and K1's
   diff emit once a batch each, its first 48 frames equal to the CPU's,
   frames/s. Its launch counts on a line of their own (filters_launches).
   The filter chain's and the EDT's kernels: KM (bgr_to_gray, once for
   FilterMonochrome on BGR), KR (resize_linear, once for FilterResize), KW
   (warp_affine, once for FilterRotate(angle=) and FilterWarpAffine) and KE
   (edt_kernel, once a distance_transform_edt call), each bit-equal to its
   plain version on the card: KM on random 1080p BGR (uint8, float32, an
   unaligned slice), KW on random gray and BGR frames under both borders,
   an out_size and an inverse map, KR on random gray and BGR down, up and
   with one axis kept, KW's two routes (a map whose tiles all stage their
   footprint, a 4x down-scale whose tiles gather: warp_affine_routes) and
   KR's (every tile staged to 960 x 540, tiles gathering to 61 wide, an
   input at a byte offset of 1: resize_linear_routes, as resize_plan
   counts them), KE
   on K1's masks, on an all-foreground and an all-background frame and on
   scenes.edt_large_scenes (the single-zero 4096 x 94 and 2898 x 2898
   masks whose sums pass 2^24, an 8K UHD motion-like mask, a 1 x 70,000
   row, 65,536 masks in two launches; its pass counts the plain loop's
   everywhere); then each
   one's ms beside its plain version's, its library call's
   (torch.matmul, F.grid_sample, F.interpolate; KE none) and its bound,
   KR also on gray frames and up to 2880 x 1620 (filter_kernels line);
   KG (gaussian_blur on float32: FilterBlur after FilterNormalize) once a
   batch gray and BGR (the channels interleaved), KS's sequential order
   (FilterBackground after FilterNormalize) once a batch, both bit-equal to
   their plain versions: KG on normalized 16-frame 1080p gray and random
   BGR at k = 3 and 5 (the cascade on non-integer input), 7, 9 sigma 1.5
   and 31, and on one column, H below the radius and a window no tile
   holds (its direct route); each timed beside its plain version, its
   bound and, for KG, two F.conv2d calls over a reflect pad (TF32 off);
7f. the multi-card half of dist/ on the one card: K1's mask and diff
   emits on one 256-frame batch of each band shape of four bands (an edge
   band of 270 + 6 rows, an interior one of 270 + 12) and K4 on each
   band's 270 interior rows of the diff emit (the strided slice the band
   path histograms) against their plain versions, bit for bit;
   SpatialStreamPipeline over a ('space',) mesh of
   four bands that all lie on cuda:0 (make_space_mesh(4, [cuda:0] * 4))
   through the clip with the bench config and with threshold="otsu", each
   run's CSV sha256 equal to REF_CSV_SHA256 / REF_OTSU_CSV_SHA256, no
   stats_overflow, its launches counted around it (K1 four a batch, one
   per band, K4 four a batch for Otsu and K1m the Otsu tail's morph_plan
   groups a band a batch, K5 one a batch, no K2, K3 or K6: the band CCL
   is torch ops), tp_recon_rounds of each batch; a checkpoint
   written after the band run's first batch resumed on the single-card
   StreamingPipeline to the same bytes; one batch's ms (CUDA events, the
   reconciliation's host reads inside), its device ms, launches and
   heaviest kernels (torch.profiler) and each run's seconds, labelled
   "4 bands sharing one card": a correctness run, no speed is claimed;
   MultiStreamPipeline over a ('stream',) mesh of two streams on cuda:0,
   its rows and merged rows equal the stream-axis route's, stream 0 at
   REF_CSV_SHA256, K1, K3 and K5 once a stream a step;
7h. tpuva's chip checks (bench/tpu_smoke.py) and BASELINE configs 1-3, the
   cases of tpuva_torch.scenes.BASELINE_CASES: config 1 (640 x 480, 300
   frames, threshold only, greedy, batch 128: K1 with no blur, a ragged
   last batch of 44), config 2 (720p, blur 5, median 3, open and close,
   Hungarian: K1's median emit and the padded handoff with 768 columns of
   padding), config 3 (the bench config on eight blobs born and dying at
   1080p), Otsu at 480p (greedy) and 4K UHD (the bench config at batch 64),
   their clips made by refimpl.synthetic in worker processes spawned at the
   start; each through process_clip(use_pallas=True) and StreamingPipeline
   over VideoMemory, its launches counted around the first run (K1 padded
   and K2 given its occupancy exactly where padded_handoff holds, else K2
   deriving it; K3 and K6 on the streamed route; K4 for Otsu; K5 a batch),
   each run's CSV sha256 equal to REF_CONFIG_CSV_SHA256's, frames/s from a
   second run (an observation, not a claim);
7i. the soak (tpuva_torch.probes.soak_100k, the counterpart of
   bench/soak_100k.py): SOAK_FRAMES (100,352) 1080p frames rendered on the
   card through process_batch_staged (K1 padded, K2 given its occupancy,
   K5: each exactly once a step, the runs' batches, the warm-up and the
   calibration, counted around the phase) with RowLog, AsyncRowDrainer and
   checkpoints; its RSS growth over the second half
   under 512 MB, a second run killed at half its batches and resumed with
   its RowLog and CSV byte-identical, the centroid median under 1 px, the
   float32-vs-float64 background drift on a 64 x 64 crop, and its rows of
   the first 2048 frames equal to the OpenCV reference's
   (REF_SOAK_PREFIX_CSV_SHA256); frames/s, the RSS and the render/step
   split on its line;
7j. the scanned background (parallel_bg, scanned_phase): KS
   (ops.background.background_scan, csrc/background.cu) against its plain
   version on the card, bit for bit (the emit and the post-batch
   background): the clip's two 256-frame batches after the filter prefix,
   from the plate, seeded, and the second carried from the first, both
   emits; N = 1, 2, 3, 7, 255, 256, 257 on (N, 120, 160) random bytes;
   (5, 250, 333), (4, 120, 1), and N = 1024 (32 pixels a CTA) and 2000
   (the global scratch) on small frames; its sequential order on FilterNormalize's
   float frames; then process_clip(parallel_bg=True) and
   StreamingPipeline(parallel_bg=True) over the clip, and process_clip
   with the plain version in KS's place, each run's CSV sha256 equal to
   REF_SCANNED_CSV_SHA256, KS, K1b, K3, K6 and K5 exactly once a batch, K1m
   its morph_plan groups, K1 never; each run's rows, track ids, rows that
   differ from the sequential route's, peak device memory, and frames/s
   after the checked run in turns with the sequential route; the front
   end's device ms on one batch on KS and on the plain version, and KS
   alone beside its plain version, bound and shared-memory estimate;
8. timing with CUDA events after warm-up at batch 256 and 1080p: K1, K1
   in padded_occ mode, K2 given K1's occupancy, deriving it and given
   every strip (the walk of every strip the kernels made before they
   skipped), on the clip's masks and on a random mask of density 0.3, K3
   (8- and 4-connected, each on density 0.3 too, 4-connected bit-equal
   first), K6 alone on K3's labels (given K3's occupancy, deriving it,
   with the dense ids, and its plain version, the torch ops the route ran
   before K6; its device time and launches a call, its own kernel's and
   any torch op's, from torch.profiler), connected_components_with_stats
   (the route's K3 + K6, and 4-connected), K1's diff
   emit and K4 against their plain versions (K1's plain version runs on
   no route: it is the kernels' yardstick of correctness), the Otsu tail
   on the batch's Otsu masks as K1m (open_close_u8) and as the torch ops
   it replaced (morph_steps_plain), bit-equal first, K7 at k = 5, 7, 9,
   11, 15 and 21 against its plain version, its histogram tier forced at k =
   7 and 9 beside the networks, and at k = 5 (256 frames) and 11 (64
   frames, the kernel on the same frames) against torch.median over the
   unfolded windows (equal first), with its bound, its design's
   operations a pixel and their time at the INT32 rate, K1b (65 taps,
   its plan) and K1m (7 x 7 rect and ellipse steps, erode and dilate, the
   rect dilate beside max_pool2d and on density 0.3; a 10-step group, one
   launch) against theirs, the split front ends of open and close 7 x 10
   (K1 + K1m's morph_plan launches) and of a 65-tap blur, K1's launch
   plan (tile, grid, CTAs resident per SM from the occupancy query,
   waves), K4 against torch.bincount over
   frame-offset keys, K5 against its plain version on the route's
   batch-256 detections and, on the bench's 16 x 8 table, on 256 frames
   of the contested and crowd streams and of an all-empty stream (the
   chain's fixed cost a frame), each bit-equal first, the whole tracker
   stage (_finish_batch: extract_detections and K5), K2's launches a call
   and device time (torch.profiler) given its occupancy, deriving it and
   on density 0.3, and its cooperative grid, and frames/s of both
   streamed routes (in turns, twice each) and of both Otsu routes, with
   the peak device memory of each streamed route;
   then the staging line (staging_timing): ms per 256-frame batch of the
   Python feeder, the native feeder and a pageable copy, in turns, 3
   repeats of 6 batches each, from the clip in memory and from a
   decoder stand-in (min, median, max), and frames/s of
   process_clip(use_pallas=True), of the streamed default route over the
   clip in memory with each feeder and over the decoder stand-in (the
   feeder the stager picks), each once untimed, then in turns, twice each;
9. the micro-probes P1-P4 (tpuva_torch.probes, the counterparts of
   bench/{repos,roll,i16,cell}_probe.py; kernels in csrc/probes.cu): every
   case's kernel bit-equal to its plain version at the probe's own tile
   (each module's CHECK_REPS: 1 and 3; 160 for P1, every dynamic amount
   r % 152 and its wrap; 140 for P2, past float32 overflow; the file's own
   count for P3 and P4); then each probe's own measuring path (measure(),
   what its main() prints) with its launch count set to 0 before and read
   after: every case slope-timed at the module's REPS, the slope positive;
   its heaviest case beside its plain version, one call each. The rep loop
   of each case that keeps its words in registers must do one add a word
   in the SASS (no rep folded into another), P3's cascades their adds,
   shifts and rescale, and no local-memory access, P4's step loops their
   mins, 40 a thread a full-tile step and 20 a cell step (no step
   folded), and the latency probe's add chains 16 adds an unrolled
   iteration. Then the latency probe (probes/latency_probe.py: one
   dependent float32 add, cast-hop, shared and DSMEM load, CTA and
   cluster barrier, int32 add and packed int16 add, each bit-equal to its
   plain version, slope-timed) and the bounds (PROBE_CHAINS): for every
   case of P1, P3 and P4 and P2's heaviest, the file's reps x the chain
   its function needs a rep, the larger of that and its operations at
   the rate of the SMs it uses, its share of the case's time, and beside
   it the pipe or memory that limits the case at its rate on those SMs
   (PROBE_PIPES). One "probes" line: each case's ns/op, Telem/s, Telem/s a
   SM and its file's-reps time, the CTAs, the rep loops' arithmetic,
   latency_ns, chain_bounds and the phase's seconds.

Then one JSON line of the kernels (each with its least time on the card,
bound_ms, from the bytes and operations of this run's inputs, and
stream_axis: whether it takes S streams a launch; fused_segment_streams
and track_scan_streams are K1 and K5 at 8 streams, phase 7d), the card
line again, and last {"ok": true, "device": {...}}. Long output (the
compiler's register and shared-memory report, CSVs, checkpoints) goes to
build/chip_smoke/.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
REPLACES = {
    "fused_segment": ("tpuva_torch/csrc/fused_segment.cu",
                      "tpuva/ops/pallas/fused_segment.py:145"),
    # K1's padded_occ mode, the staged route's handoff to K2
    "fused_segment_padded_occ": ("tpuva_torch/csrc/fused_segment.cu",
                                 "tpuva/ops/pallas/fused_segment.py:145"),
    # K2 deriving the strip occupancy from the mask
    "ccl_stats": ("tpuva_torch/csrc/ccl.cu",
                  "tpuva/ops/pallas/ccl.py:623"),
    # K2 given the strip occupancy (from K1's occ128)
    "ccl_stats_occ": ("tpuva_torch/csrc/ccl.cu",
                      "tpuva/ops/pallas/ccl.py:623"),
    "ccl_labels": ("tpuva_torch/csrc/ccl.cu",
                   "tpuva/ops/pallas/ccl.py:220"),
    # K3 4-connected (the ops API; no route selects it)
    "ccl_labels_conn4": ("tpuva_torch/csrc/ccl.cu",
                         "tpuva/ops/pallas/ccl.py:220"),
    # K6, the dense stats of K3's labels, given K3's strip occupancy
    "root_stats": ("tpuva_torch/csrc/ccl.cu",
                   "tpuva/ops/label.py:554"),
    "fused_segment_diff": ("tpuva_torch/csrc/fused_segment.cu",
                           "tpuva/ops/pallas/fused_segment.py:145"),
    "histogram_u8": ("tpuva_torch/csrc/otsu.cu",
                     "tpuva/ops/filters.py:268"),
    "track_scan": ("tpuva_torch/csrc/track.cu",
                   "tpuva/graph/pipeline.py:341"),
    # K1 and K5 with the stream axis: S streams in one launch (phase 7d)
    "fused_segment_streams": ("tpuva_torch/csrc/fused_segment.cu",
                              "tpuva/ops/pallas/fused_segment.py:145"),
    "track_scan_streams": ("tpuva_torch/csrc/track.cu",
                           "tpuva/graph/pipeline.py:341"),
    # K1's blur and morphology where one K1 launch cannot hold them
    "blur_u8": ("tpuva_torch/csrc/wide.cu",
                "tpuva/ops/pallas/fused_segment.py:145"),
    "morph_u8": ("tpuva_torch/csrc/wide.cu",
                 "tpuva/ops/pallas/fused_segment.py:145"),
    # the exact k x k median of uint8 frames (a median k > 3; tpuva's jnp):
    # the selection networks (k <= 9) and the sliding histogram (k >= 11)
    "median_u8": ("tpuva_torch/csrc/median.cu", "tpuva/ops/filters.py:208"),
    "median_u8_hist": ("tpuva_torch/csrc/median.cu", "tpuva/ops/filters.py:208"),
    # the filter chain's and the EDT's XLA stages (phase 7e): KM, KW, KR, KE
    "bgr_to_gray": ("tpuva_torch/csrc/filters.cu", "tpuva/filters.py:202"),
    "warp_affine": ("tpuva_torch/csrc/filters.cu", "tpuva/ops/warp.py:59"),
    "resize_linear": ("tpuva_torch/csrc/filters.cu", "tpuva/filters.py:220"),
    "edt": ("tpuva_torch/csrc/distance.cu", "tpuva/ops/distance.py:65"),
    # the float Gaussian blur (KG), FilterBlur on float frames (phase 7e)
    "gaussian_blur_f32": ("tpuva_torch/csrc/filters.cu", "tpuva/ops/filters.py:148"),
    # the float background (KS): the scanned order of every parallel_bg
    # route (phase 7j), the sequential order of FilterBackground on float
    # frames (phase 7e)
    "background_scan": ("tpuva_torch/csrc/background.cu", "tpuva/graph/pipeline.py:85"),
    "background_scan_sequential": ("tpuva_torch/csrc/background.cu", "tpuva/filters.py:403"),
    # the band path's CCL (KB, phase 7f): the band labels on global scan
    # keys, a reconciliation round (its snapshot and its minimum), the
    # piece table and its sums
    "band_labels": ("tpuva_torch/csrc/ccl.cu", "tpuva/dist/spatial.py:191"),
    "recon_edges": ("tpuva_torch/csrc/spatial.cu", "tpuva/dist/spatial.py:229"),
    "recon_min": ("tpuva_torch/csrc/spatial.cu", "tpuva/dist/spatial.py:229"),
    "piece_table": ("tpuva_torch/csrc/spatial.cu", "tpuva/dist/spatial.py:289"),
    "piece_sums": ("tpuva_torch/csrc/spatial.cu", "tpuva/dist/spatial.py:308"),
    # the micro-probes P1-P4, phase 9
    "repos_probe": ("tpuva_torch/csrc/probes.cu", "bench/repos_probe.py:51"),
    "roll_probe": ("tpuva_torch/csrc/probes.cu", "bench/roll_probe.py:50"),
    "i16_probe": ("tpuva_torch/csrc/probes.cu", "bench/i16_probe.py:40"),
    "cell_probe": ("tpuva_torch/csrc/probes.cu", "bench/cell_probe.py:62"),
}
BENCH_KW = dict(
    alpha=0.02, threshold=35.0, blur_ksize=5, blur_sigma=0.0,
    open_shape="rect", open_ksize=3, close_shape="ellipse", close_ksize=3,
)
K1_CONFIGS = {
    "bench": BENCH_KW,
    "blur7_sigma1.5": dict(BENCH_KW, blur_ksize=7, blur_sigma=1.5),
    "median3": dict(BENCH_KW, median_ksize=3),
    "iters2": dict(BENCH_KW, open_iters=2, close_iters=2),
    "blur3": dict(BENCH_KW, blur_ksize=3),
    "blur9": dict(BENCH_KW, blur_ksize=9),
}
# owned tiles K1's timing forces beside the plan's (the one-wave
# candidates at 1080p and a two-wave one), to show which way the clip goes
K1_TIMED_TILES = ((64, 64), (32, 128), (64, 128), (32, 64), (16, 64), (16, 128), (32, 32))
MAX_COMPONENTS = 32
# table shapes (max_tracks, max_blobs) of phase 5b's synthetic streams, and
# the one whose arrays exceed a CTA's shared memory
K5_SHAPES = ((16, 8), (3, 8), (64, 16))
K5_GLOBAL_SHAPE = (600, 100)
# sha256 of format_rows(rows) that the OpenCV reference pipeline
# (refimpl.pipeline.run_pipeline, bench config, max_dist 80, Hungarian)
# gives on the slice's clip with its plate: 3115 rows, 17 track ids. The
# clip's running-average background (alpha 0.02) absorbs slow blobs and
# leaves ghosts that split and merge tracks, so the reference itself puts
# 79.8% of its rows within 1 px of the analytic truth; the port is held
# to the reference, row for row. Recipe: README.md, "PyTorch / H100 port".
REF_CSV_SHA256 = "192715d242a4867c8ac98eb277c4e9d8f5d7abebdcf4b41b21740e540c131d5c"
# The same for the bench config with threshold="otsu": 3069 rows, 6 track
# ids. The reference is refimpl.pipeline.run_pipeline with each frame's
# threshold taken by tpuva's float32 otsu_from_histogram instead of cv2's
# double-precision THRESH_OTSU, the rule the port carries bit for bit. On
# this clip cv2's rule picks another threshold (87 vs 88) on 5 of the 512
# frames, and tpuva's own run differs by its FMA-contracted background;
# both are ROADMAP Queue 3 faults of the reference. Recipe: README.md.
REF_OTSU_CSV_SHA256 = "cab7f8b6247d373a23eb8f50831221d025ee95866fc75ae197b76b9045867ed9"
# The same for the bench config with median=MedianConfig(5) (cv2.medianBlur
# after the blur): 3117 rows, 17 track ids. Recipe: README.md.
REF_MEDIAN5_CSV_SHA256 = "fdbc3baf72c239fa2bb06c830f9d7b72718e15232191a8a9c36cf4db605360b1"
# The same with median=MedianConfig(15), K7's histogram tier on the route:
# 3093 rows, 12 track ids. Recipe: README.md.
REF_MEDIAN15_CSV_SHA256 = "0738bfd441e7dd4a3304b9e232c13c8469ca2993a45b000f4a22a076e609f4ae"
# Phase 7j: the bench config with parallel_bg=True (tpuva's associative
# scan of the background, another float32 order than the sequential
# update) through process_clip on the card with KS's plain version
# (ops/background.py::background_scan_plain, the torch ops the route ran
# before KS): 3115 rows, 17 track ids; one row differs from
# REF_CSV_SHA256's (frame 355, a blob's area 1851 against 1852). The CPU
# tests hold the route to tpuva's row for row at 96 x 256.
REF_SCANNED_CSV_SHA256 = "b1454d20328167a9d5399124dcb53b07a65da7e5e752d116aa0362a518f031c5"
# Phase 7h: the OpenCV reference (refimpl.pipeline.run_pipeline) on each
# case of tpuva_torch.scenes.BASELINE_CASES, its clip from its plate; the
# rows and track ids of each reference beside it. otsu_480p's reference
# takes each frame's threshold by tpuva's float32 rule, as
# REF_OTSU_CSV_SHA256 does (ROADMAP Queue 3, R2). Recipe: README.md.
REF_CONFIG_CSV_SHA256 = {
    "config1_480p": "9696f1c21459d0df8f095ddc766658e505b05e25a610fe40d37ae954b3d1109f",  # 324, 3
    "config2_720p": "25d067a6d8f12598b04bd38e10ad9a1c3a5d9b46514ad85be6520d29420bdd9e",  # 581, 13
    "config3_births": "1972a1974f0ef0d8c090730807ed7edc8f944c50964f40fc5cdcb95efede9b46",  # 2541, 27
    "otsu_480p": "0c0bddc5d4470e72c95cb21505b1e2c348e272c23d7f2ee029c7c9394659bca7",  # 775, 6
    "uhd_4k": "328aa5edcd4da9f8bd35eddf8d6b83d5edc301a5b5c626288970da19dad49c90",  # 774, 7
}
# Phase 7i: the OpenCV reference on the soak's first 2048 frames
# (soak_100k.PREFIX_FRAMES) at 1080p (tpuva_torch.probes.soak_100k.
# render_frames_np, build_cfg, background0 None: both sides seed the
# background from the first filtered frame): 12344 rows, 22 track ids.
# Rows are causal, so the soak's rows of those frames give these bytes.
# Recipe: README.md.
REF_SOAK_PREFIX_CSV_SHA256 = "6e03ec7f0016de4aef4820885dafe569f759b5bfbf014d3515513986a274e5b4"
# the soak's frames: BASELINE config 4's 100k, 392 batches of 256 (the
# phase takes ~1 min, so the default run and --soak both run it whole)
SOAK_FRAMES = 100_352

# Published H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, and the
# float32 rate outside the tensor cores, taken for the scalar integer and
# float32 operations of these kernels (none uses the tensor cores).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Least scalar operations per pixel of K2 and K3: block flags and link
# tests of the union-find, the stats adds (K2) or the label write (K3).
CCL_OPS_PER_PX = 5
# K2's strip: 2 rows x 256 columns of the mask
STRIP_PX = 512


T_START = time.monotonic()


def say(phase, **kv):
    """Print a phase's line, with the script's seconds so far (at_s)."""
    print(json.dumps({"phase": phase, "at_s": round(time.monotonic() - T_START, 1), **kv}),
          flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bench_cfg(config, batch, threshold=35.0):
    return config.PipelineConfig(
        background=config.BackgroundConfig(alpha=0.02),
        blur=config.BlurConfig(ksize=5, sigma=0.0),
        morph_open=config.MorphConfig(ksize=3, shape="rect"),
        morph_close=config.MorphConfig(ksize=3, shape="ellipse"),
        segment=config.SegmentConfig(threshold=threshold, min_area=50, max_blobs=8),
        track=config.TrackConfig(max_dist=80.0, death_patience=5,
                                 max_tracks=16, assigner="hungarian"),
        batch=batch,
    )


def cuda_ms(fn, reps, warm=True):
    """Mean ms of fn() over reps launches, CUDA events, after one warm-up
    (none when warm is False: a call of seconds, timed once)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops):
    """(least ms on the card, what bounds it): the larger of the bytes
    over the memory rate and the operations over the scalar peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def near_share(mask, R):
    """Share of the pixels of an (N, H, W) mask within R rows and columns
    of its foreground (separable max pooling, in float16)."""
    f = mask[:, None].to(torch.float16)
    f = torch.nn.functional.max_pool2d(f, (1, 2 * R + 1), stride=1, padding=(0, R))
    f = torch.nn.functional.max_pool2d(f, (2 * R + 1, 1), stride=1, padding=(R, 0))
    return int(f.count_nonzero()) / f.numel()


def diff_kwargs(kw):
    """K1's emit="diff" options from a mask-emit config: no threshold, no
    morphology."""
    keep = ("alpha", "blur_ksize", "blur_sigma", "median_ksize")
    return dict({k: v for k, v in kw.items() if k in keep}, threshold=0.0, emit="diff")


def blur_ops_per_px(ksize):
    """Least scalar operations a pixel of the separable integer blur of
    ksize taps, which are symmetric (cv2's; tests/test_torch_wide.py holds
    blur_taps to it): per axis t[k](a + b) for each of the (ksize - 1) / 2
    pairs (an add and a multiply-add) and the centre tap's multiply, then
    the rounding add and shift."""
    return 2 * (3 * (ksize - 1) // 2 + 1) + 2 if ksize > 1 else 0


def k1_ops_per_px(kw):
    """Least scalar operations per pixel of K1 for a config: the blur
    (blur_ops_per_px), the background update, |F - B| and the threshold or
    the rounding (6), and each erode or dilate (separable for a rect SE, 2(k-1) min/max; one per SE
    point past the first otherwise)."""
    from tpuva_torch.ops.filters import structuring_element

    ops = blur_ops_per_px(kw.get("blur_ksize", 0)) + 6
    ops += 38 if kw.get("median_ksize", 0) == 3 else 0  # 19 exchanges
    for shape, key, iters in (("open_shape", "open_ksize", "open_iters"),
                              ("close_shape", "close_ksize", "close_iters")):
        ks = kw.get(key, 0)
        if ks > 1:
            if kw.get(shape) == "rect":
                per = 2 * (ks - 1)
            else:
                per = int(structuring_element(kw[shape], ks).sum()) - 1
            ops += 2 * kw.get(iters, 1) * per
    return ops


def probe_modules():
    from tpuva_torch.probes import cell_probe, i16_probe, repos_probe, roll_probe

    return {"repos_probe": repos_probe, "roll_probe": roll_probe, "i16_probe": i16_probe,
            "cell_probe": cell_probe}


def probe_heaviest(mod):
    """The case of a probe with the most operations a rep (the first of
    equals)."""
    return max(mod.CASES, key=lambda c: c.n_ops)


def probe_bounds():
    """Least time on the card (ms, and what bounds it) of one call of each
    micro-probe's heaviest case at its file's largest rep count: the tile
    read and written once (u8; int32 for P4), and reps x n_ops scalar
    operations an element, as the file counts them (a roll one op)."""
    out = {}
    for name, mod in probe_modules().items():
        x = mod.make_tile()
        nbytes = 2 * x.numel() * x.element_size()
        ops = x.numel() * mod.FILE_REPS * probe_heaviest(mod).n_ops
        out[name] = bound(nbytes, ops)
    return out


# The chain of dependent operations a rep that each case's function needs
# (P2's heaviest case only), counted from csrc/probes.cu, each with its
# latency-probe case. P1: the i32 add one add, the cast-hop its own case, a
# roll a shared load, the add and a CTA barrier (its words cross threads).
# P2's cascade and P3's four cases, on the same code: the band's halo
# crosses from the neighbouring CTA once a rep (a cluster barrier and a
# DSMEM load), then the rep's 8 dependent adds and the rescale: P2 the
# multiply and the last add (10 f32 adds in all); P3's float32 the
# multiply (9 f32 adds), int32 the shift (9 i32 adds); the packed cases
# their 8 adds and the rescale's permute, priced as an i32 add: int16 the
# packed add and 4 funnel shifts (the axis-0 steps) beside it, uint16 the
# i32 add, each axis-0 step's shift and add one LEA.HI (its SASS). P4: a step an exchange and a min, a CTA barrier where it
# crosses warps (an axis-1 step); the exchange priced as a shared load (a
# shuffle crosses the same crossbar) and the min as an f32 add (the
# latency probe has neither: ptxas regroups a chain of mins against
# operands that do not depend on it).
_ROLL = {"shared load": 1, "f32 add": 1, "CTA barrier": 1}
_HALO = {"cluster barrier (4 CTAs)": 1, "DSMEM load": 1}
PROBE_CHAINS = {
    "repos_probe": {"i32 add (baseline)": {"i32 add": 1}, "i32 static roll26 + add": _ROLL,
                    "i32 dynamic roll + add": _ROLL, "i32 dyn-uniform roll + add": _ROLL,
                    "f32 cast-hop f->i->f + add": {"cast-hop f->i->f + 1": 1},
                    "f32 static roll + add": _ROLL},
    "roll_probe": {"k5 cascade (17 ops)": dict(_HALO, **{"f32 add": 10})},
    "i16_probe": {"float32": dict(_HALO, **{"f32 add": 9}), "int32": dict(_HALO, **{"i32 add": 9}),
                  "int16": dict(_HALO, **{"packed add (int16)": 8, "i32 add": 5}),
                  "uint16": dict(_HALO, **{"i32 add": 9})},
    "cell_probe": {"baseline_min": {"shared load": 8, "f32 add": 8},
                   "extract_roundtrip": {"shared load": 4, "f32 add": 4},
                   "baseline_sweepish": {"shared load": 64, "f32 add": 64, "CTA barrier": 32},
                   "cell_sweepish": {"shared load": 64, "f32 add": 66, "CTA barrier": 32}},
}
# the probes bounded by the larger of that chain and their operations at
# the rate of the SMs they use (a CTA an SM: CTAS/SMS of the card's peak)
PROBE_SM_BOUND = ("repos_probe", "roll_probe", "i16_probe", "cell_probe")
SMS = 132  # an H100 SXM's SMs
SM_CLOCK_HZ = 1.98e9  # an H100 SXM's boost clock
# The pipe or memory that limits a case on the SMs it uses, in clocks a
# word a rep (the card's published rates an SM): P1's i32 add one IADD at
# 64 integer lanes a clock; the cast-hop one F2I at 16 a clock; a roll 8 B
# (a 4-byte shared load and store) at shared memory's 128 B a clock; P3's
# cases a tile element a rep, without the halo rows the window adds (32
# rows for 28), from the rep loop's SASS: float32 8 FADD and the rescale's
# FMUL at 128 a clock; int32 8 adds and a SHF, ptxas's adds split between
# IADD3 (the ALU's 64 lanes) and IMAD.IADD (the FMA pipe's 64), so 128 a
# clock at best; the packed cases a word of two elements, int16 8
# VIADD.16x2, 4 funnel shifts (SHF) and the rescale's PRMT at the ALU's 64,
# uint16 4 adds, 4 LEA.HI (an axis-0 step's shift and add) and the PRMT at
# 128 at best; P4 a min a word a step at 64 a clock (cell_sweepish: half
# the words, and the cell's min and max). Beside P3's rows the issue bound
# (probe_issue): the rep loop's instructions at one warp instruction a clock
# an SM sub-partition.
_SHARED = ("shared memory, 8 B a word at 128 B a clock an SM", 8 / 128)
PROBE_PIPES = {
    ("repos_probe", "i32 add (baseline)"): ("IADD, 64 lanes a clock an SM", 1 / 64),
    ("repos_probe", "i32 static roll26 + add"): _SHARED,
    ("repos_probe", "i32 dynamic roll + add"): _SHARED,
    ("repos_probe", "i32 dyn-uniform roll + add"): _SHARED,
    ("repos_probe", "f32 cast-hop f->i->f + add"): ("F2I, 16 a clock an SM", 1 / 16),
    ("repos_probe", "f32 static roll + add"): _SHARED,
    ("i16_probe", "float32"): ("FADD and FMUL, 128 lanes a clock an SM", 9 / 128),
    ("i16_probe", "int32"): ("IADD3 or IMAD.IADD and SHF, 128 integer lanes a clock an SM",
                             9 / 128),
    ("i16_probe", "int16"): ("VIADD.16x2, SHF and PRMT, 64 lanes a clock an SM", 13 / 2 / 64),
    ("i16_probe", "uint16"): ("IMAD.IADD, LEA.HI and PRMT, 128 integer lanes a clock an SM",
                              9 / 2 / 128),
    ("cell_probe", "baseline_min"): ("mins, 64 a clock an SM", 8 / 64),
    ("cell_probe", "extract_roundtrip"): ("mins, 64 a clock an SM", 4 / 64),
    ("cell_probe", "baseline_sweepish"): ("mins, 64 a clock an SM", 64 / 64),
    ("cell_probe", "cell_sweepish"): ("mins, 64 a clock an SM", 33 / 64),
}


def probe_chain_bounds(entries, lines):
    """The latency probe's cases bit-equal to its plain version, their
    latencies (ns, the slope between its REPS), and the bound of each case
    in PROBE_CHAINS at its file's reps: its chain (the reps x the
    latencies) and, for PROBE_SM_BOUND, the larger of that and the case's
    operations on its CTAs' SMs (which binds is "binds"), its share of the
    case's time (lines: phase 9's rows), and the limiting pipe of
    PROBE_PIPES at its rate on those SMs (pipe_ms) beside it; the
    whole-card operations bound of the heaviest case (entries: the
    kernels line) too. Returns (latencies, {probe: {case: bound}})."""
    from tpuva_torch.probes import latency_probe as lp

    x = lp.make_tile().to("cuda")
    for case in lp.CASES:
        for reps in lp.CHECK_REPS:
            if not torch.equal(lp.run(x, case.name, reps), lp.plain(x.cpu(), case.name, reps)
                               .to("cuda")):
                raise AssertionError(f"latency probe {case.name} at {reps} reps differs from "
                                     "its plain version")
    ns = lp.measure("cuda", iters=3)
    if not all(v > 0 for v in ns.values()):
        raise AssertionError(f"latency probe: a latency is not positive: {ns}")
    mods, bounds = probe_modules(), {}
    for name, chains in PROBE_CHAINS.items():
        mod, reps = mods[name], mods[name].FILE_REPS
        words = mod.make_tile().numel()
        bounds[name] = {}
        for case in mod.CASES:
            if case.name not in chains:
                continue
            chain = chains[case.name]
            per_rep = sum(n * ns[op] for op, n in chain.items())
            chain_ms = reps * per_rep / 1e6
            sm_ms = words * reps * case.n_ops / (PEAK_OPS_S * mod.CTAS / SMS) * 1e3
            b, binds = chain_ms, "chain"
            if name in PROBE_SM_BOUND and sm_ms > chain_ms:
                b, binds = sm_ms, "operations on its SMs"
            ms = lines[name]["cases"][case.name]["file_reps_ms"]
            row = {"reps": reps, "chain": chain, "ns_a_rep": per_rep, "chain_ms": chain_ms,
                   "sm_operations_bound_ms": sm_ms, "bound_ms": b, "binds": binds, "ms": ms,
                   "share": b / ms}
            if (name, case.name) in PROBE_PIPES:
                what, clocks = PROBE_PIPES[(name, case.name)]
                pipe_ms = words / mod.CTAS * reps * clocks / SM_CLOCK_HZ * 1e3
                row.update(pipe=what, pipe_ms=pipe_ms, pipe_share=pipe_ms / ms)
            if case.name == lines[name]["heaviest"]:
                row["operations_bound_ms"] = entries[name]["bound_ms"]
            bounds[name][case.name] = row
    return ns, bounds


# the micro-probes' cases that keep their words in registers, and the
# arithmetic one rep does to a word: "IADD" counts VIADD, IADD3 and
# IMAD.IADD (sass_op)
PROBE_REGISTER_CASES = {
    ("repos_probe", 0): {"IADD": 1},  # i32 add
    ("repos_probe", 4): {"F2I": 1, "I2FP": 1, "FADD": 1},  # the cast-hop
    ("roll_probe", 0): {"FADD": 2},  # f + f + 1e-7
    ("roll_probe", 1): {"FMUL": 1, "FADD": 1},  # f * 1.0001 + 1e-7
}
# P3's cascades (P2's code): a thread's 4 x 9 tile elements, 36 words at 32
# bits and 18 packed; a rep's 8 adds a word (the 16 ops are 8 rolls and 8
# adds), the axis-0 steps' 4 funnel shifts a packed word, the rescale (an
# FMUL, a SHF, a PRMT) a word; at least these (the loop's own address and
# count arithmetic adds IADDs): uint16's shift and add are one LEA.HI
PROBE_CASCADE_LOOPS = {
    0: {"FADD": 8 * 36, "FMUL": 36},  # float32
    1: {"IADD": 8 * 36, "SHF": 36},  # int32
    2: {"VIADD.16x2": 8 * 18, "SHF": 4 * 18, "PRMT": 18},  # int16
    3: {"IADD+LEA": 8 * 18, "PRMT": 18},  # uint16
}
# the latency probe's add chains: 16 adds an iteration of the unrolled loop
LATENCY_ADD_LOOPS = {6: "IADD", 7: "VIADD.16x2"}
# P4's loops, every case in registers: (the mins of an iteration of its
# step loop, the innermost loop, and of its rep loop outside that one): a
# full-tile step does 40 a thread, a cell step 20; baseline_min's and
# extract_roundtrip's step loops run one step an iteration (8 and 4 times,
# extract's on both row planes), the sweeps one sweep of 4 steps (16
# times); cell_sweepish's rep loop also takes v = min(top, bottom) and
# max(v, bottom) (20 + 20). "MNMX" counts IMNMX and VIMNMX, min or max.
PROBE_SWEEP_LOOPS = {0: (40, 0), 1: (40, 0), 2: (4 * 40, 0), 3: (4 * 20, 2 * 20)}
SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)\s*([^;]*);")


def sass_op(op):
    """An opcode of probe_sass's counts: the 32-bit adds (VIADD, IADD3,
    IMAD.IADD) as IADD, the packed add as VIADD.16x2, else the opcode
    without its modifiers."""
    if op.startswith("VIADD.16x2"):
        return "VIADD.16x2"
    if op.split(".")[0] in ("VIADD", "IADD3") or op.startswith("IMAD.IADD"):
        return "IADD"
    return op.split(".")[0]


def probe_sass():
    """Hold the rep loop of each probe case that keeps its words in
    registers (PROBE_REGISTER_CASES) to its arithmetic, from the SASS of
    the built library (cuobjdump): the one loop, a backward branch, does
    each word's operations once, so that no rep is folded into another
    (ptxas merged the adds of unrolled reps once, and such a case ran
    faster than the SM's lanes allow). P3's cascades the same way
    (PROBE_CASCADE_LOOPS), and no local-memory load or store in their
    loops. P4's cases by their mins (PROBE_SWEEP_LOOPS): its step loop
    inside its rep loop, each step's mins there, none folded into the next.
    The latency probe's add chains: 16 adds in their unrolled loop
    (LATENCY_ADD_LOOPS), none merged. Returns {case: {opcode: count in the
    loop}}; raises where a count is not the case's."""
    from collections import Counter

    from tpuva_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    mods, out = probe_modules(), {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        k = re.search(r"\d(repos|roll|i16|cell|lat)6kernelILi(\d)E", fn.split("\n", 1)[0])
        if not k:
            continue
        name, i = f"{k.group(1)}_probe<{k.group(2)}>", int(k.group(2))
        if k.group(1) == "lat":
            name = f"latency_probe<{i}>"
        insns = [(int(a, 16), op, args) for a, op, args in SASS_INSN.findall(fn)]
        loops = [(int(to, 16), at) for at, op, args in insns if op.split(".")[0] == "BRA"
                 for to in re.findall(r"^0x([0-9a-f]+)", args.strip()) if int(to, 16) < at]

        def count(loop):
            return Counter(sass_op(op) for at, op, _ in insns if loop[0] <= at <= loop[1])

        if k.group(1) == "cell":
            if len(loops) != 2:
                raise AssertionError(f"{name}: {len(loops)} loops in its SASS, not a step loop "
                                     "in the rep loop")
            inner, outer = sorted(loops, key=lambda lp: lp[1] - lp[0])
            if not outer[0] <= inner[0] < inner[1] <= outer[1]:
                raise AssertionError(f"{name}: its step loop is not inside its rep loop")
            mins = [sum(n for op, n in count(lp).items() if "MNMX" in op) for lp in (inner, outer)]
            out[name] = {"step_loop_mins": mins[0], "rep_loop_mins": mins[1] - mins[0]}
            want = PROBE_SWEEP_LOOPS[i]
            if (mins[0], mins[1] - mins[0]) != want:
                raise AssertionError(f"{name}: its loops do {out[name]} mins, not {want}: steps "
                                     "are folded or lost")
            continue
        if k.group(1) == "lat":
            if i not in LATENCY_ADD_LOOPS:
                continue
            op = LATENCY_ADD_LOOPS[i]
            out[name] = {op: max((count(lp)[op] for lp in loops), default=0)}
            if out[name][op] < 16:  # the loop's count is one more IADD
                raise AssertionError(f"{name}: its unrolled loop does {out[name]}, not 16 {op}: "
                                     "adds are merged or lost")
            continue
        if k.group(1) == "i16":
            want = PROBE_CASCADE_LOOPS[i]
        else:
            per_rep = PROBE_REGISTER_CASES.get((f"{k.group(1)}_probe", i))
            if not per_rep:
                continue
            mod = mods[f"{k.group(1)}_probe"]
            words = -(-mod.make_tile().numel() // (mod.CTAS * 1024))  # a thread, 1024 a CTA
            want = {op: words * n for op, n in per_rep.items()}
        if len(loops) != 1:
            raise AssertionError(f"{name}: {len(loops)} loops in its SASS, not the rep loop alone")
        ops = count(loops[0])
        out[name] = {op: sum(ops[o] for o in op.split("+")) for op in want}
        if k.group(1) == "i16":
            short = any(out[name][op] < n for op, n in want.items())
            out[name]["instructions"] = sum(ops.values())  # the loop's, for probe_issue
        else:
            short = out[name] != want
        if short:
            raise AssertionError(f"{name}: its rep loop does {out[name]}, not {want}: reps are "
                                 "folded or lost")
        if ops["LDL"] or ops["STL"]:
            raise AssertionError(f"{name}: its rep loop loads or stores local memory (spills)")
    want = (len(PROBE_REGISTER_CASES) + len(PROBE_CASCADE_LOOPS) + len(PROBE_SWEEP_LOOPS)
            + len(LATENCY_ADD_LOOPS))
    if len(out) != want:
        raise AssertionError(f"the SASS holds {sorted(out)} of the probes' register cases")
    return out


def probe_issue(bounds, loops):
    """Beside each P3 case's bound (bounds: probe_chain_bounds's rows) the
    time its rep loop's instructions take to issue (loops: probe_sass's
    counts, the loop's static instructions, edge groups' branches
    included): 1024 threads, one warp instruction a clock on each of an
    SM's 4 sub-partitions, at SM_CLOCK_HZ."""
    from tpuva_torch.probes import i16_probe

    for i, case in enumerate(i16_probe.CASES):
        row = bounds[case.name]
        n = loops[f"i16_probe<{i}>"]["instructions"]
        issue_ms = row["reps"] * n * 1024 / 128 / SM_CLOCK_HZ * 1e3
        row.update(loop_instructions=n, issue_ms=issue_ms, issue_share=issue_ms / row["ms"])


def once_ms(fn):
    """ms of one call of fn(), CUDA events, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def probes_phase(card):
    """Phase 9: every case of the micro-probes P1-P4 bit-equal to its plain
    version on the card, then each probe's measure() path with its launch
    count read around it; one "probes" line. Returns the probes' entries
    of the kernels line."""
    t_phase = time.time()
    dev = torch.device("cuda")
    bounds = probe_bounds()
    entries, lines = {}, {}
    for name, mod in probe_modules().items():
        x = mod.make_tile().to(dev)
        err = 0.0
        for case in mod.CASES:
            for reps in mod.CHECK_REPS:
                got, ref = mod.run(x, case.name, reps), mod.plain(x, case.name, reps)
                err = max(err, float((got.double() - ref.double()).abs().max()))
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name} {case.name} at {reps} reps differs from its "
                                         f"plain version: max abs err {err}")
        mod.run.launches = 0
        rows = mod.measure(dev, iters=1)
        launches = mod.run.launches
        if launches == 0:
            raise AssertionError(f"{name}: measure() launched no kernel")
        flat = [r["case"] for r in rows if not r["ns_per_op"] > 0]
        if flat:
            raise AssertionError(f"{name}: the time does not grow with the reps: {flat}")
        heavy, reps = probe_heaviest(mod), mod.FILE_REPS
        row = next(r for r in rows if r["case"] == heavy.name)
        ms = row["t1_ms"] if row["r1"] == reps else row["t2_ms"]
        plain_ms = once_ms(lambda: mod.plain(x, heavy.name, reps))
        entries[name] = {"name": name, "route": "cuda", "source": REPLACES[name][0],
                         "replaces": REPLACES[name][1], "launches": launches,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                         "library_ms": None}
        lines[name] = {"ctas": f"{mod.CTAS} CTA(s) x 1024 threads, one an SM",
                       "heaviest": heavy.name, "heaviest_reps": reps,
                       "cases": {r["case"]: dict({k: r[k] for k in (
                           "n_ops", "r1", "r2", "t1_ms", "t2_ms", "ns_per_op", "telem_s",
                           "telem_s_per_sm")}, file_reps_ms=r["t1_ms"] if r["r1"] == reps
                           else r["t2_ms"]) for r in rows}}
    latency_ns, chain_bounds = probe_chain_bounds(entries, lines)
    loops = probe_sass()
    p3 = lines["i16_probe"]["cases"]  # P3's question: each case's time a rep against int32's
    lines["i16_probe"]["per_int32"] = {c: p3[c]["ns_per_op"] / p3["int32"]["ns_per_op"] for c in p3}
    probe_issue(chain_bounds["i16_probe"], loops)
    say("probes", card=card, bit_equal=True, seconds=round(time.time() - t_phase, 1),
        probes=lines, register_rep_loops=loops, latency_ns=latency_ns,
        chain_bounds=chain_bounds, kernels=list(entries.values()))
    return entries


def padded_stats(mask):
    """(the mask zero-padded to 64 x 256, its strip occupancy on the mask's
    device): the handoff tpuva's staged route builds where no occ128 is
    given."""
    from tpuva_torch.ops.ccl import strip_occupancy_plain

    N, H, W = mask.shape
    padded = torch.zeros((N, -(-H // 64) * 64, -(-W // 256) * 256), dtype=torch.uint8,
                         device=mask.device)
    padded[:, :H, :W] = mask
    return padded, strip_occupancy_plain(padded.cpu()).to(mask.device)


def k5_ops(T, D, N):
    """Least scalar operations of K5 for N frames of a (T, D) table: the
    cost (two differences, two products, a sum, a root and a select an
    entry), the fast path's column minimum and equality count (two an
    entry), and about ten a slot and a detection for the update and the
    row. Frames that take the Jonker-Volgenant search do more: this is the
    least that every frame needs."""
    return N * (9 * T * D + 10 * (T + D))


STAT_KEYS = ("count", "area", "centroid", "centroid_sum")
K2_KEYS = STAT_KEYS + ("overflow",)  # K2 writes the stats dict's overflow too
CC_KEYS = ("labels", "count", "area", "bbox", "centroid", "centroid_sum", "overflow")


def check_equal(err, kernel, pairs, where):
    """Raise unless every (name, kernel output, plain output) is bit-equal;
    fold the max abs difference into err[kernel]."""
    for what, got, ref in pairs:
        e = float((got.double() - ref.double()).abs().max()) if got.numel() else 0.0
        err[kernel] = max(err[kernel], e)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"{kernel} {what} differs from its plain version ({where}): "
                f"max abs err {e}")


def check_track_scan(err, state, dets, valid, frame0, where, kernel="track_scan", **kw):
    """K5 on the card against track_scan_plain on the CPU from the same
    state (with or without a stream axis): rows, row_valid and every state
    tensor equal, float bits included (so -0.0 is not +0.0), the max abs
    difference folded into err[kernel]. Returns the card's (state, rows,
    row_valid)."""
    from tpuva_torch.track.scan import track_scan, track_scan_plain
    from tpuva_torch.track.table import TrackState

    dev = torch.device("cuda")
    ref = track_scan_plain(TrackState(*(x.cpu() for x in state)), dets.cpu(), valid.cpu(),
                           frame0.cpu(), **kw)
    got = track_scan(TrackState(*(x.to(dev) for x in state)), dets.to(dev), valid.to(dev),
                     frame0.to(dev), **kw)
    pairs = [(f"state.{n}", g.cpu(), r) for n, g, r in zip(TrackState._fields, got[0], ref[0])]
    pairs += [("rows", got[1].cpu(), ref[1]), ("row_valid", got[2].cpu(), ref[2])]
    check_equal(err, kernel, pairs, where)
    for what, g, r in pairs:
        if g.dtype == torch.float32 and not torch.equal(g.view(torch.int32), r.view(torch.int32)):
            raise AssertionError(f"{kernel} {what}: the sign of a zero differs ({where})")
    return got


def ptxas_kernel(entry, probes=False):
    """The short name of a mangled kernel of the ptxas report that
    ptxas_summary keeps, or None."""
    if probes:
        k = re.search(r"\d(repos|roll|i16|cell)6kernelILi(\d+)E", entry)
        return f"{k.group(1)}_probe<{k.group(2)}>" if k else None
    patterns = ((r"fused_segment_kernelILi(\d+)ELi(\d+)ELi(\d+)E", "fused_segment_kernel"),
                (r"blur_tile_kernelILb([01])E", "blur_tile_kernel"),
                (r"track_scan_regsILi(\d+)E", "track_scan_regs"),
                (r"track_scan_kernelILb([01])E", "track_scan_kernel"),
                (r"morph_group_kernel()", "morph_group_kernel"),
                (r"median_net_kernelILi(\d+)E", "median_net_kernel"),
                (r"median_hist_kernelI([htj])Li(\d+)E", "median_hist_kernel"),
                (r"ccl_stats_persistent()", "ccl_stats_persistent"),
                (r"k6_frameILi(\d+)ELb([01])E", "k6_frame"),
                (r"\d(ccl4_(?:occ|tiles|local|border|labels))E", None),
                (r"edt_band_kernelILb([01])ELb([01])E", "edt_band_kernel"),
                (r"edt_round_rows_kernelILb([01])E", "edt_round_rows_kernel"),
                (r"\d(bgr2gray_(?:u8|f32)_vec)", None),
                (r"bgr2gray_pxI([hf])E", "bgr2gray_px"),
                (r"warp_affine_kernelI([hf])Li(\d)ELb([01])E", "warp_affine_kernel"),
                (r"resize_linear_kernelI([hf])Li(\d)E", "resize_linear_kernel"))
    for pattern, name in patterns:
        k = re.search(pattern, entry)
        if k and name is None:  # the name is the match
            return k.group(1)
        if k and name == "median_hist_kernel":  # its count type, mangled
            return f"{name}<{dict(h='u8', t='u16', j='u32')[k.group(1)]}, {k.group(2)}>"
        if k:
            return f"{name}<{', '.join(k.groups())}>" if k.group(1) else name
    return None


def ptxas_summary(log, probes=False):
    """{kernel: {"registers": n, "spill_stores": b, "spill_loads": b}} of the
    K1 instantiations, K1m's and K1b's tiled kernels, K7's network and
    histogram kernels, K2's persistent kernel, K3 4-connected's kernels,
    K6's and K5's kernels, KE's, KM's, KW's and KR's (probes: of the
    micro-probes' cases, csrc/probes.cu) in nvcc's -Xptxas -v report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = ptxas_kernel(m.group(1), probes)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def k1_plans(H, W, configs):
    """K1's launch plan on the card for each (name, options): tile, grid,
    CTAs resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    waves over the card's SMs, shared memory per CTA."""
    from tpuva_torch.ops.fused_segment import card_blocks_per_sm, fused_segment_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, kw in configs:
        p = fused_segment_plan(H, W, blocks_per_sm=card_blocks_per_sm, sms=sms, **kw)
        out[name] = dict(tile=list(p.tile), grid=list(p.grid), blocks_per_sm=p.blocks_per_sm,
                         waves=p.waves, smem_bytes=p.smem, sms=sms)
    return out


def k1_timing(clip, plate, card):
    """--k1: K1 and K1-diff at batch 256 and 1080p with the plan's tile
    and with each of K1_TIMED_TILES forced, bit-equal to the plain version
    first, CUDA events; one JSON line. For iterating on K1 alone."""
    from tpuva_torch.ops.fused_segment import _fused_segment_cuda, fused_segment, fused_segment_plain

    dev = torch.device("cuda")
    frames = torch.from_numpy(clip[:256]).to(dev)
    bg0 = torch.from_numpy(plate.astype(np.float32)).to(dev)
    configs = (("k1", BENCH_KW), ("k1_diff", diff_kwargs(BENCH_KW)))
    t = {"plans": k1_plans(1080, 1920, configs)}
    for name, kw in configs:
        ref = fused_segment_plain(frames, bg0, **kw)
        for r, g in zip(ref, fused_segment(frames, bg0, **kw)):
            if not torch.equal(r, g):
                raise AssertionError(f"{name} differs from its plain version at batch 256")
        del ref
        t[f"{name}_ms"] = cuda_ms(lambda: fused_segment(frames, bg0, **kw), 5)
        for tile in K1_TIMED_TILES:
            t[f"{name}_ms_tile_{tile[0]}x{tile[1]}"] = cuda_ms(
                lambda: _fused_segment_cuda(frames, bg0, tile=tile, **kw), 5)
    # a static scene (every frame the plate): no foreground, so no tile runs
    # the morphology; the difference to k1_ms is what the clip's
    # foreground tiles add
    static = torch.from_numpy(np.rint(plate).astype(np.uint8)).to(dev).expand(256, -1, -1)
    static = static.contiguous()
    t["static_scene_foreground_px"] = int(fused_segment(static, bg0, **BENCH_KW)[0].count_nonzero())
    t["k1_ms_static_scene"] = cuda_ms(lambda: fused_segment(static, bg0, **BENCH_KW), 5)
    say("k1_timing", card=card, batch=256, shape=[1080, 1920], bit_equal=True, **t)
    return 0


def kernel_breakdown(fn, reps=3):
    """{CUDA kernel name: [mean device ms a call, launches a call]} of fn()
    under torch.profiler, one profiling session a call; a session that saw
    no kernel at all is run again, up to twice (on the card the profiler
    now and then dropped one kernel of a session, or all of them); empty
    where it never saw device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(reps):
        for _attempt in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            seen = [(ev.key[:60], getattr(ev, "device_time_total",
                                          getattr(ev, "cuda_time_total", 0)), ev.count)
                    for ev in prof.key_averages()]
            seen = [x for x in seen if x[1] > 0]
            if seen:
                break
        for name, us, count in seen:
            ms_n = out.setdefault(name, [0.0, 0])
            ms_n[0] += us / 1e3 / reps
            ms_n[1] += count / reps
    out = {k: [round(ms, 4), n] for k, (ms, n) in out.items()}
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def k6_launches(breakdown):
    """(K6's kernel launches, other kernel launches) a call of a
    kernel_breakdown: K6's kernels are named k6_*, any other kernel is a
    torch op's."""
    k6 = sum(n for name, (_ms, n) in breakdown.items() if "k6_" in name)
    return k6, sum(n for _ms, n in breakdown.values()) - k6


def device_summary(breakdown):
    """(device ms a call, kernel launches a call) of a kernel_breakdown."""
    return (round(sum(ms for ms, _n in breakdown.values()), 4),
            sum(n for _ms, n in breakdown.values()))


def k2_phases(mask, strip_occ, H, W, reps=5):
    """{phase: mean µs} of K2's persistent kernel (ops.ccl.K2_PHASES, the
    epilogue left out) from CTA 0's clock after each grid barrier, over
    reps calls after a warm-up, and the tiles it visited."""
    from tpuva_torch.ops.ccl import K2_PHASES, _label_stats_cuda

    ns = torch.zeros(9, dtype=torch.int64, device=mask.device)
    total = np.zeros(7)
    for i in range(reps + 1):
        _label_stats_cuda(mask, MAX_COMPONENTS, strip_occ, H, W, phase_ns=ns)
        torch.cuda.synchronize()
        if i:
            total += np.diff(ns[:8].cpu().numpy())
    out = {phase: round(float(us), 2) for phase, us in zip(K2_PHASES, total / reps / 1e3)}
    return dict(out, tiles=int(ns[8]))


def k2_timing(clip, plate, card):
    """--k2: K2 (label_stats), K3 (label_components_tiled, 8- and
    4-connected), K6 (the dense stats, ops.label._stats_from_root, on K3's
    labels) and the default route's call of both (connected_components_
    with_stats, no bbox, no labels; and its 4-connected call) at batch 256
    and 1080p on the clip's K1 masks and a random mask of density 0.3, CUDA
    events, with each call's kernels by name, device time and launches
    (torch.profiler; for K6, its own kernels' launches and any other
    kernel's, a torch op's); one JSON line. The calls that exist in both
    this tree and its parent run first, so that this file, copied into a
    checkout of the parent, times the parent's kernels the same way; then
    those only this tree has: K2 with the caller's strip occupancy (K1's
    occ128, every strip), K6 given K3's occupancy (8- and 4-connected),
    with the dense ids, and its plain version."""
    import inspect

    from tpuva_torch.ops import ccl
    from tpuva_torch.ops import label as lb
    from tpuva_torch.ops.ccl import label_components_tiled, label_stats
    from tpuva_torch.ops.fused_segment import fused_segment

    dev = torch.device("cuda")
    frames = torch.from_numpy(clip[:256]).to(dev)
    bg0 = torch.from_numpy(plate.astype(np.float32)).to(dev)
    masks = fused_segment(frames, bg0, **BENCH_KW)[0]
    dense = torch.rand((256, 1080, 1920), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(30)) < 0.3
    dense = dense.to(torch.uint8) * 255
    root = label_components_tiled(masks, 8)
    root_dense = label_components_tiled(dense, 8)
    root4 = label_components_tiled(masks, 4)
    k6_kw = dict(compute_bbox=False, compute_labels=False)
    calls = {"k2_clip": lambda: label_stats(masks, MAX_COMPONENTS),
             "k2_dense": lambda: label_stats(dense, MAX_COMPONENTS),
             "k3_clip": lambda: label_components_tiled(masks, 8),
             "k3_dense": lambda: label_components_tiled(dense, 8),
             "k6_clip": lambda: lb._stats_from_root(root, MAX_COMPONENTS, 8, **k6_kw),
             "k6_dense": lambda: lb._stats_from_root(root_dense, MAX_COMPONENTS, 8, **k6_kw),
             "cc_stats_clip": lambda: lb.connected_components_with_stats(
                 masks, MAX_COMPONENTS, **k6_kw),
             "k3_conn4_clip": lambda: label_components_tiled(masks, 4),
             "k3_conn4_dense": lambda: label_components_tiled(dense, 4),
             "k6_conn4_clip": lambda: lb._stats_from_root(root4, MAX_COMPONENTS, 4, **k6_kw),
             "cc_stats_conn4_clip": lambda: lb.connected_components_with_stats(
                 masks, MAX_COMPONENTS, 4, **k6_kw)}
    if "strip_occ" in inspect.signature(label_stats).parameters:
        padded, _bg, occ128 = fused_segment(frames, bg0, padded_occ=True, **BENCH_KW)
        strip_occ = occ128.reshape(256, 576, 8, 2).amax(dim=3)
        dense_padded, dense_occ = padded_stats(dense)
        occ_kw = dict(H=1080, W=1920)
        calls.update({
            "k2_occ_clip": lambda: label_stats(padded, MAX_COMPONENTS, strip_occ=strip_occ,
                                               **occ_kw),
            "k2_every_strip_clip": lambda: label_stats(
                padded, MAX_COMPONENTS, strip_occ=torch.ones_like(strip_occ), **occ_kw),
            "k2_occ_dense": lambda: label_stats(dense_padded, MAX_COMPONENTS,
                                                strip_occ=dense_occ, **occ_kw)})
    if hasattr(ccl, "root_labels"):
        root_occ = ccl.root_labels(masks, 8)[1]
        dense_root_occ = ccl.root_labels(dense, 8)[1]
        calls.update({
            "k6_occ_clip": lambda: lb._stats_from_root(root, MAX_COMPONENTS, 8,
                                                       strip_occ=root_occ, **k6_kw),
            "k6_occ_dense": lambda: lb._stats_from_root(root_dense, MAX_COMPONENTS, 8,
                                                        strip_occ=dense_root_occ, **k6_kw),
            "k6_labels_occ_clip": lambda: lb._stats_from_root(
                root, MAX_COMPONENTS, 8, compute_bbox=False, compute_labels=True,
                strip_occ=root_occ),
            "k6_plain_clip": lambda: lb._stats_from_root_plain(root, MAX_COMPONENTS, 8,
                                                               **k6_kw)})
        root4_occ = ccl.root_labels(masks, 4)[1]
        if root4_occ is not None:  # K3 4-connected hands K6 its occupancy
            calls["k6_occ_conn4_clip"] = lambda: lb._stats_from_root(
                root4, MAX_COMPONENTS, 4, strip_occ=root4_occ, **k6_kw)
    t = {}
    for name, fn in calls.items():
        t[f"{name}_ms"] = cuda_ms(fn, 10)
        t[f"{name}_kernels"] = kernel_breakdown(fn)
        t[f"{name}_device_ms"], t[f"{name}_launches"] = device_summary(t[f"{name}_kernels"])
        if name.startswith("k6_") and "plain" not in name:
            t[f"{name}_k6_launches"], t[f"{name}_torch_op_launches"] = k6_launches(
                t[f"{name}_kernels"])
    if hasattr(ccl, "K2_PHASES"):  # K2's persistent kernel: its phases' times
        t["k2_phases_us"] = {
            "occ_clip": k2_phases(padded, strip_occ, 1080, 1920),
            "clip": k2_phases(masks, None, 1080, 1920),
            "occ_dense": k2_phases(dense_padded, dense_occ, 1080, 1920)}
    say("k2_timing", card=card, batch=256, shape=[1080, 1920], **t)
    return 0


def time_k5(cfg, masks, bg_last, plate, route_dets, err, reps):
    """K5 (track_scan) at batch N = len(masks) on cfg's table, CUDA events:
    the whole tracker stage (_finish_batch: extract_detections and K5) on
    the masks' stats; K5 on the route's detections and its plain version
    (the loop of torch ops the route ran before K5); K5 on N frames of the
    contested and crowd streams (Jonker-Volgenant frames, births at
    capacity) and of an all-empty stream (the chain's fixed cost a frame),
    each bit-equal to the plain version first. Every call here exists in
    earlier checkouts too (--k5 runs it there)."""
    from tpuva_torch.graph.pipeline import _finish_batch, init_carry
    from tpuva_torch.ops.ccl import label_stats
    from tpuva_torch.scenes import det_sequence
    from tpuva_torch.track.scan import track_scan, track_scan_plain
    from tpuva_torch.track.table import init_track_state

    dev = masks.device
    N = masks.shape[0]
    t_kw = dict(max_dist=cfg.track.max_dist, death_patience=cfg.track.death_patience,
                assigner=cfg.track.assigner)
    t = {}
    carry0 = init_carry(cfg, *masks.shape[1:], plate, device=dev)
    stats = label_stats(masks, MAX_COMPONENTS)
    t["tracker_ms"] = cuda_ms(
        lambda: _finish_batch(cfg, carry0, stats, bg_last), reps)
    k5_args = (carry0.track, *route_dets, carry0.frame_idx)
    check_track_scan(err, *k5_args, f"route detections, batch {N}", **t_kw)
    t["k5_ms"] = cuda_ms(lambda: track_scan(*k5_args, **t_kw), reps)
    t["k5_us_per_frame"] = 1e3 * t["k5_ms"] / N
    t["k5_plain_ms"] = cuda_ms(lambda: track_scan_plain(*k5_args, **t_kw), 2)
    T5, D5 = cfg.track.max_tracks, cfg.segment.max_blobs
    streams = {kind: det_sequence(kind, D5, frames=N, seed=5) for kind in ("contested", "crowd")}
    streams["empty"] = (np.zeros((N, D5, 3), np.float32), np.zeros((N, D5), bool))
    for kind, (d, v) in streams.items():
        args = (init_track_state(T5, dev), torch.from_numpy(d).to(dev),
                torch.from_numpy(v).to(dev), torch.zeros((), dtype=torch.int32, device=dev))
        check_track_scan(err, *args, f"{kind} stream, batch {N}", **t_kw)
        t[f"k5_{kind}_ms"] = cuda_ms(lambda: track_scan(*args, **t_kw), reps)
        t[f"k5_{kind}_us_per_frame"] = 1e3 * t[f"k5_{kind}_ms"] / N
    return t


def k5_timing(clip, plate, card):
    """--k5: time_k5 at batch 256 and 1080p on the bench config, the route's
    detections from K1 and K2 on the clip's first batch; one JSON line.
    Copied into an earlier checkout, the same file times that checkout's
    K5."""
    from tpuva_torch.graph import config
    from tpuva_torch.graph.pipeline import _front_end_kwargs
    from tpuva_torch.ops.ccl import label_stats
    from tpuva_torch.ops.fused_segment import fused_segment
    from tpuva_torch.ops.label import extract_detections

    dev = torch.device("cuda")
    cfg = bench_cfg(config, 256)
    masks, bg_last = fused_segment(torch.from_numpy(clip[:256]).to(dev),
                                   torch.from_numpy(plate.astype(np.float32)).to(dev),
                                   **_front_end_kwargs(cfg))
    dets, _n, valid, _s = extract_detections(label_stats(masks, MAX_COMPONENTS),
                                             cfg.segment.min_area, cfg.segment.max_blobs)
    err = {"track_scan": 0.0}
    t = time_k5(cfg, masks, bg_last, plate, (dets, valid), err, 10)
    say("k5_timing", card=card, batch=256, shape=[1080, 1920], bit_equal=True, **t)
    return 0


def wide_calls(frames, bg0, masks, kw):
    """The K1m (morph_u8) and K1b (blur_u8) calls that the timing phase and
    --wide both time at batch 256 and 1080p: name -> (kernel, call, plain
    version), the plain version None for a front end. K1m: one 7 x 7 step
    of the clip's K1 masks (rect and ellipse, erode and dilate), a rect
    dilate of a random mask of density 0.3, and ten steps (open 7 x 5) as
    ten one-step calls; K1b: a 65-tap blur of the frames; then the split
    front ends of open and close 7 x 10 (K1 + K1m's launches) and of a
    65-tap blur (K1b + K1). These exist in this tree and its parent, so
    that this file, copied into a checkout of the parent, times the
    parent's kernels the same way. Then those only this tree has: the ten
    steps as one morph_steps group, and a 7 x 7 rect dilate and the group
    on the masks as bytes 0/254, which take K1m's general min/max path
    where 0/255 tiles take AND/OR."""
    from tpuva_torch.ops import wide
    from tpuva_torch.ops.filters import _morph, gaussian_blur_u8, structuring_element
    from tpuva_torch.ops.fused_segment import fused_segment

    dev = frames.device
    dense = torch.rand(masks.shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(31)) < 0.3
    dense = dense.to(torch.uint8) * 255
    se7 = structuring_element("rect", 7)
    steps10 = [(se7, True)] * 5 + [(se7, False)] * 5

    def chain(step, x):  # the ten steps, one call each
        for se, erode in steps10:
            x = step(x, se, erode)
        return x

    calls = {}
    for shape in ("rect", "ellipse"):
        se = structuring_element(shape, 7)
        for erode in (False, True):
            calls[f"k1m_{shape}7_{'erode' if erode else 'dilate'}"] = (
                "morph_u8", lambda se=se, erode=erode: wide.morph_u8(masks, se, erode),
                lambda se=se, erode=erode: _morph(masks, se, erode))
    calls["k1m_dense_rect7_dilate"] = ("morph_u8", lambda: wide.morph_u8(dense, se7, False),
                                       lambda: _morph(dense, se7, False))
    calls["k1m_10_calls"] = ("morph_u8", lambda: chain(wide.morph_u8, masks),
                             lambda: chain(_morph, masks))
    calls["k1b_65"] = ("blur_u8", lambda: wide.blur_u8(frames, 65),
                       lambda: gaussian_blur_u8(frames, 65).to(torch.uint8))
    calls["k1_split_reach120"] = (None, lambda: fused_segment(frames, bg0, **dict(
        kw, open_ksize=7, open_iters=10, close_ksize=7, close_iters=10)), None)
    calls["k1_split_blur65"] = (None, lambda: fused_segment(frames, bg0, **dict(kw, blur_ksize=65)),
                                None)
    if hasattr(wide, "morph_steps"):
        m254 = masks // 255 * 254
        calls["k1m_group10"] = ("morph_u8", lambda: wide.morph_steps(masks, steps10),
                                lambda: chain(_morph, masks))
        calls["k1m_rect7_dilate_0_254"] = ("morph_u8", lambda: wide.morph_u8(m254, se7, False),
                                           lambda: _morph(m254, se7, False))
        calls["k1m_group10_0_254"] = ("morph_u8", lambda: wide.morph_steps(m254, steps10),
                                      lambda: chain(_morph, m254))
    return calls


def time_wide_calls(calls, err, reps):
    """Each of wide_calls' calls checked bit for bit against its plain
    version (check_equal into err), then timed over reps launches (a front
    end over 2): ms by name."""
    t = {}
    for name, (kernel, fn, plain) in calls.items():
        if plain is not None:
            check_equal(err, kernel, [(name, fn(), plain())], "batch 256, 1080p")
        t[f"{name}_ms"] = cuda_ms(fn, reps if plain is not None else 2)
    return t


def wide_timing(clip, plate, card):
    """--wide: wide_calls through their entry points, K1 alone, and, where
    this tree has blur_plan, K1b at 65 taps on other tiles than
    blur_plan's and without __dp4a/__dp2a_lo; one JSON line."""
    from tpuva_torch.ops import wide
    from tpuva_torch.ops.filters import gaussian_blur_u8
    from tpuva_torch.ops.fused_segment import fused_segment

    dev = torch.device("cuda")
    frames = torch.from_numpy(clip[:256]).to(dev)
    bg0 = torch.from_numpy(plate.astype(np.float32)).to(dev)
    masks = fused_segment(frames, bg0, **BENCH_KW)[0]
    calls = wide_calls(frames, bg0, masks, BENCH_KW)
    calls["k1"] = (None, lambda: fused_segment(frames, bg0, **BENCH_KW), None)
    if hasattr(wide, "blur_plan"):
        from tpuva_torch import _build
        from tpuva_torch.ops.filters import blur_taps

        taps, shift = blur_taps(65)

        def k1b_forced(tile, dp):
            out = torch.empty_like(frames)
            _build.launch(dev, "tpuva_blur_u8", "blur_u8 kernel",
                          frames.data_ptr(), out.data_ptr(), *frames.shape,
                          wide._device_ints(taps, dev).data_ptr(), len(taps), shift, *tile, dp,
                          wide.blur_smem(*tile, len(taps)))
            return out

        blurred = lambda: gaussian_blur_u8(frames, 65).to(torch.uint8)  # noqa: E731
        for tile, dp in (((128, 64), 0), ((128, 128), 1), ((64, 64), 1), ((256, 32), 1)):
            calls[f"k1b_65_{tile[0]}x{tile[1]}_dp{dp}"] = (
                "blur_u8", lambda tile=tile, dp=dp: k1b_forced(tile, dp), blurred)
    t = time_wide_calls(calls, {"morph_u8": 0.0, "blur_u8": 0.0}, 5)
    say("wide_timing", card=card, batch=256, shape=[1080, 1920], bit_equal=True, **t)
    return 0


# K7's checks: windows at 1080p (batch 256), on the 160 x 240 clip, and on
# edge shapes (H or W below the window, one row, one pixel) for the
# network kernels (k <= 9) and the sliding histogram (k >= 11: 8-bit
# counts to k = 15, 16-bit to 255, 32-bit past)
MEDIAN_K_1080P = (3, 5, 7, 11, 15)
MEDIAN_K_CLIP = (9, 25)
MEDIAN_K_EDGE = (3, 5, 7, 9, 11, 25, 255)
# the ragged widths: not a multiple of the 16-byte loads, the 4-byte
# stores or a thread's 4 or 8 columns
MEDIAN_RAGGED_W = (1, 2, 3, 5, 37)
MEDIAN_EDGE_SHAPES = ((2, 8, 300), (2, 300, 8), (2, 1, 300), (1, 1, 1), (3, 5, 7), (2, 40, 70)) + \
    tuple((2, 9, w) for w in MEDIAN_RAGGED_W)
# past k = 255 on three of them: the plain version's window stack is k*k
# slices, seconds a call in Python
MEDIAN_K_LARGE = (435, 437)
MEDIAN_LARGE_SHAPES = ((2, 8, 300), (2, 300, 8), (2, 40, 70))
# 1080-row frames: the ragged widths, a width no tile or 16-byte load
# divides, and the adversarial frames (tpuva_torch.scenes.median_adversarial)
MEDIAN_K_ROWS = (3, 5, 7, 9, 11, 15)
MEDIAN_RAGGED_1080P = tuple((2, 1080, w) for w in MEDIAN_RAGGED_W + (1917,))
MEDIAN_ADVERSARIAL_SHAPE = (2, 1080, 1920)
# windows whose sorted stack would not fit at 1080p, against
# median_u8_counts_plain: two frames of the clip, two random frames with a
# dark half, the adversarial frames
MEDIAN_K_COUNTS = (25, 51, 255, 257, 437)
# the windows timed at 1080p, batch 256: the median route's 5, the
# networks' 7 and 9 (beside MEDIAN_K_CROSS), the histogram tier's 11, 15
# (the median-15 route) and 21;
# the sorted plain version at the first three (13 s a call at 15, more at 21)
MEDIAN_K_TIMED = (5, 7, 9, 11, 15, 21)
MEDIAN_K_PLAIN_TIMED = (5, 7, 11)
# the histogram tier forced beside the networks: the crossover
MEDIAN_K_CROSS = (7, 9)
# torch.median over the unfolded windows at k = 11 on this many frames (a
# 16 GB window copy), the kernel on the same frames
MEDIAN_LIBRARY_K11_FRAMES = 64
# the median route's windows (phase 7g) and their pinned CSVs
MEDIAN_ROUTE_REFS = {5: REF_MEDIAN5_CSV_SHA256, 15: REF_MEDIAN15_CSV_SHA256}
# H100 SXM's INT32 rate: 64 INT32 lanes an SM (Hopper white paper) x 132 SMs
# x the 1.98 GHz boost clock, for the integer min/max of K7's networks
PEAK_INT32_S = 132 * 64 * 1.98e9


# the window and frames of K7's entries in the kernels line
K7_AT = {"median_u8": {"at": "k=5, (256, 1080, 1920)"},
         "median_u8_hist": {"at": "k=11, (64, 1080, 1920)"}}


def k7_name(ksize, forced=False):
    """K7's name in the kernels line for window ksize: its networks
    (median_u8) or its sliding histogram (median_u8_hist, from k = 11 or
    forced)."""
    return "median_u8_hist" if forced or ksize >= 11 else "median_u8"


def median_ops_per_px(ksize):
    """Least scalar operations a pixel of the k x k median: a sliding
    window histogram (Huang) adds the k values that enter the window and
    removes the k that leave it (its walk to the median is amortised)."""
    return 2 * ksize


def median_radix_ops_per_px(ksize):
    """Operations a pixel of the radix select (K7's design for k > 9 before
    its sliding histogram, and for every k before its networks): 8 counts
    of the k*k window, a compare and an add a value."""
    return 8 * 2 * ksize * ksize


def median_design_ops_per_px(ksize):
    """(operations a pixel, design) of the kernel this tree runs for ksize:
    its network's instructions over the lanes plus loads, staging and
    stores (ops.median.network_ops_per_px), its sliding histogram's
    (ops.median.hist_ops_per_px), or the radix select's where the tree has
    neither (an earlier checkout running this file)."""
    try:
        from tpuva_torch.ops.median import NET_BLOCKS, network_ops_per_px
    except ImportError:
        return median_radix_ops_per_px(ksize), "radix"
    if ksize in NET_BLOCKS:
        return network_ops_per_px(ksize)["total"], "network"
    try:
        from tpuva_torch.ops.median import hist_ops_per_px
    except ImportError:
        return median_radix_ops_per_px(ksize), "radix"
    return hist_ops_per_px(ksize)["total"], "histogram"


def median_hist_plans(sizes=((256, 1080, 1920), (1, 1080, 1920)), ks=(11, 15, 21, 255, 257)):
    """The histogram tier's plan on the card (tpuva_median_hist_plan: count
    bytes, threads, strip rows, shared bytes, SMs, CTAs an SM from the
    occupancy query) for each size and k, held to ops/median.py::hist_plan
    at the card's SM count; {} in a tree without the tier."""
    import ctypes

    from tpuva_torch import _build
    try:
        from tpuva_torch.ops.median import hist_plan
    except ImportError:
        return {}
    lib = _build.load()
    out, plans = (ctypes.c_int * 7)(), {}
    for N, H, W in sizes:
        for k in ks:
            _build.check(lib, lib.tpuva_median_hist_plan(N, H, W, k, out), "median plan")
            card = dict(zip(("count_bytes", "threads", "strip", "smem", "sms", "ctas_an_sm",
                             "hist_min_k"), out))
            want = hist_plan(N, H, W, k, sms=card["sms"])
            if any(card[n] != want[n] for n in ("count_bytes", "threads", "strip", "smem")):
                raise AssertionError(f"median plan at {N, H, W}, k = {k}: card {card}, {want}")
            card["grid"] = list(want["grid"])
            card["warps_an_sm"] = card["ctas_an_sm"] * card["threads"] // 32
            plans[f"{N}x{H}x{W} k={k}"] = card
    return plans


def median_checks(frames, small, err):
    """K7 (median_u8) against its plain version (median_u8_plain) on the
    card, bit for bit: frames (batch 256, 1080p) at MEDIAN_K_1080P, the
    small clip at MEDIAN_K_CLIP, random bytes of MEDIAN_EDGE_SHAPES at
    MEDIAN_K_EDGE and of MEDIAN_LARGE_SHAPES at MEDIAN_K_LARGE; at
    MEDIAN_K_ROWS, 1080-row frames of the ragged widths (random bytes, a
    dark half) and the adversarial frames (tpuva_torch.scenes.
    median_adversarial); at MEDIAN_K_COUNTS, where the sort's window stack
    would not fit at 1080p, against median_u8_counts_plain on two frames of
    the clip, two random frames and the adversarial frames; the histogram
    tier forced at MEDIAN_K_CROSS (median_hist_u8) on two frames and the
    adversarial ones; its plan on the card (median_hist_plans). The checks
    a tree lacks (an earlier checkout) are left out. Returns the phase
    line's fields."""
    from tpuva_torch.ops import median as om
    from tpuva_torch.ops.median import median_u8, median_u8_plain
    try:
        from tpuva_torch.scenes import median_adversarial
    except ImportError:  # an earlier checkout running this file: no adversarial frames
        def median_adversarial(shape, seed):
            return {}

    dev = torch.device("cuda")
    cases = [(f"k={k}, {list(frames.shape)}", frames, k, median_u8) for k in MEDIAN_K_1080P]
    f_small = torch.from_numpy(small).to(dev)
    cases += [(f"k={k}, clip {list(small.shape)}", f_small, k, median_u8) for k in MEDIAN_K_CLIP]
    rng = np.random.default_rng(17)
    for shape in MEDIAN_EDGE_SHAPES:
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        ks = MEDIAN_K_EDGE + (MEDIAN_K_LARGE if shape in MEDIAN_LARGE_SHAPES else ())
        cases += [(f"k={k}, {list(shape)}", x, k, median_u8) for k in ks]
    for shape in MEDIAN_RAGGED_1080P:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        x[:, : shape[1] // 2] //= 8
        x = torch.from_numpy(x).to(dev)
        cases += [(f"k={k}, {list(shape)}", x, k, median_u8) for k in MEDIAN_K_ROWS]
    adversarial = {name: torch.from_numpy(x).to(dev) for name, x in
                   median_adversarial(MEDIAN_ADVERSARIAL_SHAPE, seed=17).items()}
    for name, x in adversarial.items():
        cases += [(f"k={k}, {name} {list(x.shape)}", x, k, median_u8) for k in MEDIAN_K_ROWS]
    hist_u8 = getattr(om, "median_hist_u8", None)
    if hist_u8 is not None:
        for name, x in [("clip", frames[:2])] + list(adversarial.items()):
            cases += [(f"histogram tier k={k}, {name}", x, k, hist_u8) for k in MEDIAN_K_CROSS]
    for where, x, k, fn in cases:
        check_equal(err, k7_name(k, fn is not median_u8), [("median", fn(x, k),
                                                            median_u8_plain(x, k))], where)
    n_counts = 0
    counts_plain = getattr(om, "median_u8_counts_plain", None)
    if counts_plain is not None:
        noise = rng.integers(0, 256, (2,) + tuple(frames.shape[1:]), dtype=np.uint8)
        noise[:, : frames.shape[1] // 2] //= 8
        large = [("clip", frames[:2]), ("random, a dark half", torch.from_numpy(noise).to(dev))]
        if adversarial:
            large.append(("adversarial", torch.cat(list(adversarial.values()))))
        for name, x in large:
            for k in MEDIAN_K_COUNTS:
                check_equal(err, k7_name(k), [("median", median_u8(x, k), counts_plain(x, k))],
                            f"k={k}, {name} {list(x.shape)}, against the counts")
                n_counts += 1
    torch.cuda.synchronize()
    return dict(comparisons=len(cases) + n_counts, k_1080p=list(MEDIAN_K_1080P),
                k_clip=list(MEDIAN_K_CLIP), k_edge=list(MEDIAN_K_EDGE),
                k_large=list(MEDIAN_K_LARGE), large_shapes=[list(s) for s in MEDIAN_LARGE_SHAPES],
                edge_shapes=[list(s) for s in MEDIAN_EDGE_SHAPES], k_rows=list(MEDIAN_K_ROWS),
                ragged_1080p=[list(s) for s in MEDIAN_RAGGED_1080P],
                adversarial=list(adversarial), k_counts=list(MEDIAN_K_COUNTS) if n_counts else [],
                k_hist_forced=list(MEDIAN_K_CROSS) if hist_u8 else [],
                hist_plans=median_hist_plans(), bit_equal=True)


def median_library(x, ksize):
    """The k x k median of x (N, H, W) uint8 by one torch.median over the
    window axis of its unfolded, replicate-padded frames (the library
    yardstick; the port never calls it). The window view is made
    contiguous inside the call."""
    N, H, W = x.shape
    r = ksize // 2
    ri = torch.clamp(torch.arange(-r, H + r, device=x.device), 0, H - 1)
    ci = torch.clamp(torch.arange(-r, W + r, device=x.device), 0, W - 1)
    win = x.index_select(1, ri).index_select(2, ci).unfold(1, ksize, 1).unfold(2, ksize, 1)
    return lambda: torch.median(win.reshape(N, H, W, ksize * ksize), dim=-1).values


def median_timing(frames, err, reps):
    """K7 at MEDIAN_K_TIMED on frames (batch 256, 1080p), CUDA events: the
    kernel, its plain version (at MEDIAN_K_PLAIN_TIMED; one call, no warm-up
    past k = 7), its histogram tier forced at MEDIAN_K_CROSS, and the
    library call (median_library, checked equal first; None where it
    raises) at k = 5 on the batch and at 11 on MEDIAN_LIBRARY_K11_FRAMES
    frames with the kernel and its plain version on the same frames, with
    the bound (bytes against median_ops_per_px), the operations a pixel
    of the design this tree runs (median_design_ops_per_px) and their time
    at the INT32 rate. Returns ms and bounds by name."""
    from tpuva_torch.ops import median as om
    from tpuva_torch.ops.median import median_u8, median_u8_plain

    t = {}
    px = frames.numel()
    for k in MEDIAN_K_TIMED:
        t[f"k7_{k}_ms"] = cuda_ms(lambda: median_u8(frames, k), reps)
        t[f"k7_{k}_plain_ms"] = (cuda_ms(lambda: median_u8_plain(frames, k), 1, warm=k <= 7)
                                 if k in MEDIAN_K_PLAIN_TIMED else None)
        t[f"k7_{k}_bound"] = bound(2 * px, median_ops_per_px(k) * px)
        ops, design = median_design_ops_per_px(k)
        t[f"k7_{k}_design"] = design
        t[f"k7_{k}_ops_per_px"] = ops
        t[f"k7_{k}_int32_bound_ms"] = ops * px / PEAK_INT32_S * 1e3
    if hasattr(om, "median_hist_u8"):
        for k in MEDIAN_K_CROSS:
            t[f"k7_hist_{k}_ms"] = cuda_ms(lambda: om.median_hist_u8(frames, k), reps)
    f64 = frames[:MEDIAN_LIBRARY_K11_FRAMES]
    px64 = f64.numel()
    t["k7_11_64_ms"] = cuda_ms(lambda: median_u8(f64, 11), reps)
    t["k7_11_64_plain_ms"] = cuda_ms(lambda: median_u8_plain(f64, 11), 1, warm=False)
    t["k7_11_64_bound"] = bound(2 * px64, median_ops_per_px(11) * px64)
    for k, x, key in ((MEDIAN_K_TIMED[0], frames, f"k7_{MEDIAN_K_TIMED[0]}_library_ms"),
                      (11, f64, "k7_11_64_library_ms")):
        try:
            lib = median_library(x, k)
            check_equal(err, k7_name(k), [("library", lib(), median_u8(x, k))],
                        f"torch.median over unfolded windows, k = {k}")
            t[key] = cuda_ms(lib, 2)
            del lib
        except (RuntimeError, NotImplementedError) as e:  # the yardstick only, never the port
            t[key] = None
            t[f"{key}_error"] = str(e)[:200]
        torch.cuda.empty_cache()
    return t


def median_route(clip, plate, cfg, counters):
    """Phase 7g: the bench config cfg with median k for each k of
    MEDIAN_ROUTE_REFS through process_clip and StreamingPipeline (twice),
    each run's CSV sha256 equal to the pin, K1b, K7, K1 and K5 exactly once
    a batch, no K1m and no torch morphology step (filters._morph counted
    around each run). counters: {name: (function, attribute)} of those
    kernels' launch counts. Returns each k's rows, track ids and runs
    (seconds, frames/s, launches)."""
    from tpuva_torch.export.csvio import format_rows
    from tpuva_torch.graph import config
    from tpuva_torch.graph.pipeline import process_clip
    from tpuva_torch.graph.streaming import StreamingPipeline
    from tpuva_torch.io.memory import VideoMemory
    from tpuva_torch.ops import filters as ops_filters

    morph, morph_calls = ops_filters._morph, []  # every torch morphology step runs _morph

    def counted_morph(*args, **kw):
        morph_calls.append(1)
        return morph(*args, **kw)

    out = {}
    for k, ref in MEDIAN_ROUTE_REFS.items():
        mcfg = dataclasses.replace(cfg, median=config.MedianConfig(k))
        batches = -(-clip.shape[0] // mcfg.batch)
        runs = {}
        for route in ("process_clip", "StreamingPipeline", "StreamingPipeline_again"):
            torch.cuda.synchronize()
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            morph_calls.clear()
            ops_filters._morph = counted_morph
            try:
                t0 = time.time()
                if route == "process_clip":
                    rows = process_clip(clip, mcfg, background0=plate,
                                        max_components=MAX_COMPONENTS, device="cuda")[0]
                else:
                    rows = StreamingPipeline(mcfg, max_components=MAX_COMPONENTS).run(
                        VideoMemory(clip), background0=plate)
                torch.cuda.synchronize()
                seconds = time.time() - t0
            finally:
                ops_filters._morph = morph
            counts = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
            want = dict(fused_segment=batches, blur_u8=batches, median_u8=batches,
                        track_scan=batches, morph_u8=0)
            if any(counts[n] != v for n, v in want.items()) or morph_calls:
                raise AssertionError(f"median {k} route through {route}: launches {counts}, "
                                     f"{len(morph_calls)} torch morphology steps")
            data = format_rows(rows).encode()
            if hashlib.sha256(data).hexdigest() != ref:
                with open(os.path.join(OUT_DIR, f"tracks_median{k}_{route}.csv"), "wb") as fh:
                    fh.write(data)
                raise AssertionError(f"median {k} route through {route}: rows differ from "
                                     "the reference's")
            runs[route] = dict(seconds=seconds, fps=clip.shape[0] / seconds, launches=counts)
        out[f"median{k}"] = dict(rows=len(rows), track_ids=len({int(r[0]) for r in rows}),
                                 csv_sha256_equals_reference=True, torch_morphology_steps=0,
                                 runs=runs)
    return out


def write_baseline_clip(name):
    """Make the clip and plate of BASELINE case `name` (refimpl.synthetic,
    numpy only) and save them under OUT_DIR; run in a worker process, so
    that the clips are made while the earlier phases use the card. Returns
    the two .npy paths."""
    from refimpl import synthetic
    from tpuva_torch.scenes import baseline_case, baseline_clip

    clip, plate = baseline_clip(baseline_case(name), synthetic)
    paths = [os.path.join(OUT_DIR, f"clip_{name}_{what}.npy") for what in ("frames", "plate")]
    for path, arr in zip(paths, (clip, plate)):
        np.save(path, arr)
    return paths


def start_baseline_clips():
    """(executor, {name: future of write_baseline_clip}): a process for
    each BASELINE case, spawned before the card is touched."""
    import concurrent.futures
    import multiprocessing
    from tpuva_torch.scenes import BASELINE_CASES

    os.makedirs(OUT_DIR, exist_ok=True)
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(BASELINE_CASES), mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(write_baseline_clip, name) for name in BASELINE_CASES}


def configs_phase(clip_futures, counters):
    """Phase 7h: each BASELINE case (tpuva_torch.scenes.BASELINE_CASES, its
    clip from clip_futures) through the staged route, process_clip(
    use_pallas=True) (K1, K2 given K1's occupancy where padded_handoff
    holds, else deriving it; for Otsu K1's diff emit and K4; K5), and the
    streamed default route, StreamingPipeline over VideoMemory (K1, K3,
    K6 given K3's occupancy, K5; for Otsu the diff emit and K4). Each
    route's launches are counted around its first run (counters: {name:
    (function, attribute)}), and each run's CSV sha256 is held to the
    case's REF_CONFIG_CSV_SHA256; frames/s from a second run. Returns
    {case: line}, with K1's launch plan at the case's size and each route's
    peak device memory."""
    from tpuva_torch.export.csvio import format_rows
    from tpuva_torch.graph.pipeline import (
        _diff_kwargs, _front_end_kwargs, _morph_stages, process_clip,
    )
    from tpuva_torch.graph.streaming import StreamingPipeline
    from tpuva_torch.io.memory import VideoMemory
    from tpuva_torch.ops.wide import morph_plan, open_close_steps
    from tpuva_torch.scenes import baseline_case

    def counts():
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    out = {}
    for name, fut in clip_futures.items():
        case = baseline_case(name)
        cfg = case.cfg
        paths = fut.result()
        clip, plate = (np.load(p) for p in paths)
        for p in paths:
            os.unlink(p)
        T, H, W = clip.shape
        batches = -(-T // cfg.batch)
        otsu = cfg.segment.threshold == "otsu"
        tail = len(morph_plan(H, W, open_close_steps(_morph_stages(cfg)))) if otsu else 0
        routes = {
            "staged": lambda: process_clip(clip, cfg, background0=plate,
                                           max_components=MAX_COMPONENTS, use_pallas=True,
                                           device="cuda")[0],
            "stream": lambda: StreamingPipeline(cfg, max_components=MAX_COMPONENTS).run(
                VideoMemory(clip), background0=plate)}
        line = dict(frames=T, shape=[H, W], batch=cfg.batch, ragged_last_batch=T % cfg.batch,
                    assigner=cfg.track.assigner, max_blobs=cfg.segment.max_blobs,
                    padded_handoff=case.padded,
                    k1_plan=k1_plans(H, W, [("diff" if otsu else "mask",
                                             (_diff_kwargs if otsu else _front_end_kwargs)(cfg))]))
        for route, run in routes.items():
            secs = []
            for rep in range(2):  # the first run counts the launches; the second is timed
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for fn, attr in counters.values():
                    setattr(fn, attr, 0)
                t0 = time.time()
                rows = run()
                torch.cuda.synchronize()
                secs.append(time.time() - t0)
                if rep == 0:
                    c = counts()
                    peak = torch.cuda.max_memory_allocated() / 2**30
                data = format_rows(rows).encode()
                if hashlib.sha256(data).hexdigest() != REF_CONFIG_CSV_SHA256[name]:
                    with open(os.path.join(OUT_DIR, f"tracks_{name}_{route}.csv"), "wb") as fh:
                        fh.write(data)
                    raise AssertionError(f"{name} through the {route} route: rows differ from "
                                         "the OpenCV reference's")
            staged = route == "staged"
            padded = staged and case.padded
            want = dict(fused_segment=batches, fused_segment_padded_occ=batches * padded,
                        ccl_stats=batches * staged, ccl_stats_occ=batches * padded,
                        ccl_labels=batches * (not staged), root_stats=batches * (not staged),
                        root_stats_occ=batches * (not staged), histogram_u8=batches * otsu,
                        morph_u8=batches * tail, track_scan=batches, blur_u8=0, median_u8=0)
            if any(c[k] != v for k, v in want.items()):
                raise AssertionError(f"{name} through the {route} route: launches {c}, "
                                     f"expected {want}")
            line[route] = dict(
                rows=len(rows), track_ids=len({int(r[0]) for r in rows}),
                csv_sha256_equals_reference=True, padded_handoff_taken=bool(padded),
                k2_deriving_occupancy=c["ccl_stats"] - c["ccl_stats_occ"],
                launches={k: v for k, v in c.items() if v}, peak_device_gib=peak,
                seconds=secs, fps=T / secs[1])
        out[name] = line
        del clip
    return out


def soak_phase(counters):
    """Phase 7i: tpuva_torch.probes.soak_100k.soak over SOAK_FRAMES 1080p
    frames rendered on the card (the staged route: K1 padded, K2 given its
    occupancy, K5, each launched exactly once a step the soak reports,
    counted around the phase; counters: {name: (function, attribute)}),
    killed at half and resumed; its rows of the first
    soak_100k.PREFIX_FRAMES frames held to REF_SOAK_PREFIX_CSV_SHA256.
    Returns its line."""
    from tpuva_torch.probes import soak_100k

    torch.cuda.synchronize()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.time()
    res = soak_100k.soak(SOAK_FRAMES, workdir=os.path.join(OUT_DIR, "soak"))
    torch.cuda.synchronize()
    c = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    # one launch each a step: the soak's every process_batch_staged call
    if not (res["steps"] == c["fused_segment"] == c["fused_segment_padded_occ"]
            == c["ccl_stats"] == c["ccl_stats_occ"] == c["track_scan"]):
        raise AssertionError(f"the soak's launches: {c}")
    if res["prefix_csv_sha256"] != REF_SOAK_PREFIX_CSV_SHA256:
        raise AssertionError(f"the soak's rows of its first {soak_100k.PREFIX_FRAMES} frames "
                             "differ from the OpenCV reference's")
    return dict(res, prefix_csv_sha256_equals_reference=True, launches={k: v for k, v in c.items() if v}, phase_seconds=time.time() - t0)


# One kernel a K7 min/max candidate, compiled alone for sm_90a so that the
# SASS shows what each intrinsic costs, and one rate kernel a candidate:
# eight independent chains of max(min(a, b), c) a thread, unrolled 4 times,
# 64 min/max a rep (median_sass)
MEDIAN_SASS_PROBE = r"""
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
__device__ __forceinline__ uint32_t hmin2_u32(uint32_t a, uint32_t b) {
  const __half2 z = __hmin2(*reinterpret_cast<const __half2*>(&a),
                            *reinterpret_cast<const __half2*>(&b));
  return *reinterpret_cast<const uint32_t*>(&z);
}
__device__ __forceinline__ uint32_t hmax2_u32(uint32_t a, uint32_t b) {
  const __half2 z = __hmax2(*reinterpret_cast<const __half2*>(&a),
                            *reinterpret_cast<const __half2*>(&b));
  return *reinterpret_cast<const uint32_t*>(&z);
}
#define PROBE(name, expr) extern "C" __global__ void probe_##name(const uint32_t* p, uint32_t* o) { \
    const uint32_t a = p[threadIdx.x], b = p[threadIdx.x + 32], c = p[threadIdx.x + 64]; \
    (void)c; o[threadIdx.x] = (expr); }
PROBE(xor, a ^ b)
PROBE(vminu2, __vminu2(a, b))
PROBE(vmaxu2, __vmaxu2(a, b))
PROBE(vimin3_u16x2, __vimin3_u16x2(a, b, c))
PROBE(vimax3_u16x2, __vimax3_u16x2(a, b, c))
PROBE(vminu4, __vminu4(a, b))
PROBE(vmaxu4, __vmaxu4(a, b))
PROBE(hmin2, hmin2_u32(a, b))
PROBE(min_u32, min(a, b))
#define STEP(x) x = MX(MN(x, b), c);
#define RATE(name, MN_, MX_) \
  extern "C" __global__ void rate_##name(uint32_t* o, int reps) { \
    auto MN = [](uint32_t u, uint32_t v) { return MN_(u, v); }; \
    auto MX = [](uint32_t u, uint32_t v) { return MX_(u, v); }; \
    uint32_t a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u, a4 = a0 * 11u, \
             a5 = a0 * 13u, a6 = a0 * 17u, a7 = a0 * 19u; \
    const uint32_t b = 0xe000e000u ^ blockIdx.x, c = 0x10001000u ^ (blockIdx.x << 3); \
    for (int r = 0; r < reps; ++r) { \
      _Pragma("unroll") for (int u = 0; u < 4; ++u) { \
        STEP(a0) STEP(a1) STEP(a2) STEP(a3) STEP(a4) STEP(a5) STEP(a6) STEP(a7) } } \
    o[blockIdx.x * blockDim.x + threadIdx.x] = a0 ^ a1 ^ a2 ^ a3 ^ a4 ^ a5 ^ a6 ^ a7; }
__device__ __forceinline__ uint32_t min3u2(uint32_t a, uint32_t b) { return __vimin3_u16x2(a, b, a ^ 1u); }
__device__ __forceinline__ uint32_t max3u2(uint32_t a, uint32_t b) { return __vimax3_u16x2(a, b, a ^ 1u); }
__device__ __forceinline__ uint32_t minu32(uint32_t a, uint32_t b) { return min(a, b); }
__device__ __forceinline__ uint32_t maxu32(uint32_t a, uint32_t b) { return max(a, b); }
RATE(vminu2, __vminu2, __vmaxu2)
RATE(vimin3_u16x2, min3u2, max3u2)
RATE(hmin2, hmin2_u32, hmax2_u32)
RATE(min_u32, minu32, maxu32)
typedef void (*RateKernel)(uint32_t*, int);
// which: 0 vminu2, 1 vimin3_u16x2, 2 hmin2, 3 min_u32; grid x 256 threads
extern "C" int median_rate(int which, uint32_t* o, int grid, int reps, void* stream) {
  const RateKernel k[] = {rate_vminu2, rate_vimin3_u16x2, rate_hmin2, rate_min_u32};
  k[which]<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(o, reps);
  return static_cast<int>(cudaGetLastError());
}
"""
MEDIAN_RATES = ("vminu2", "vimin3_u16x2", "hmin2", "min_u32")


def sass_functions(path):
    """{function: [opcode, ...]} of cuobjdump -sass's listing of path."""
    from tpuva_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def median_sass(lib_path):
    """The SASS of K7's min/max forms and kernels: each candidate
    intrinsic's instructions past the baseline's (MEDIAN_SASS_PROBE, nvcc
    for sm_90a), each candidate's rate (min/max a clock an SM, the SM clock
    read from nvidia-smi; CUDA events over 8 CTAs an SM), and for each
    network kernel median_net_kernel<k> of the library its instruction
    count, its opcodes, and its 16-bit-lane min/max instructions
    (VIMNMX*.U16) against the network's ops (one instruction an op where
    the form is native) and against its two-input comparisons on LANES
    pixels each (a min3 or max3 is two)."""
    import ctypes

    from tpuva_torch import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, "median_sass_probe.cu")
    lib = os.path.join(OUT_DIR, "median_sass_probe.so")
    with open(src, "w") as fh:
        fh.write(MEDIAN_SASS_PROBE)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True, capture_output=True,
                   text=True)
    probe = sass_functions(lib)
    base = len(probe["probe_xor"]) - 1  # the xor is one LOP3
    intrinsics = {name[len("probe_"):]: dict(extra=len(ops) - base,
                                             ops=[o for o in ops if o not in probe["probe_xor"]])
                  for name, ops in probe.items() if name.startswith("probe_") and name != "probe_xor"}
    rate_lib = ctypes.CDLL(lib)
    rate_lib.median_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid, reps = 8 * sms, 4096
    o = torch.empty(grid * 256, dtype=torch.int32, device="cuda")
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True).stdout.split()[0])
    rates = {}
    for i, name in enumerate(MEDIAN_RATES):
        def run():
            _build.check(_build.load(), rate_lib.median_rate(
                i, o.data_ptr(), grid, reps, torch.cuda.current_stream().cuda_stream), name)
        ms = cuda_ms(run, 3)
        minmax = sum(1 for op in probe[f"rate_{name}"] if "MNMX" in op)
        per_clock_sm = grid * 256 * reps * 64 / (ms * 1e-3) / (clock * 1e6) / sms
        rates[name] = dict(ms=ms, sass_minmax=minmax, minmax_a_clock_an_sm=per_clock_sm)
    kernels = {}
    try:
        from tpuva_torch.ops.median import LANES, median_network
    except ImportError:
        median_network = None
    for name, ops in sass_functions(lib_path).items():
        m = re.search(r"median_(net)_kernelILi(\d+)E|median_(hist)_kernelI([htj])Li(\d+)E", name)
        if not m:
            continue
        hist = {}
        for op in ops:
            hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
        entry = dict(instructions=len(ops), opcodes=dict(sorted(hist.items(), key=lambda x: -x[1])))
        if m.group(3):  # the sliding histogram, by its count type
            kernels[f"median_hist_kernel<{dict(h='u8', t='u16', j='u32')[m.group(4)]}, "
                    f"{m.group(5)}>"] = entry
            continue
        k = int(m.group(2))
        if median_network is not None:
            net = median_network(k)
            minmax = sum(1 for op in ops if op.startswith("VIMNMX") and ".U16" in op)
            entry.update(net_ops=len(net.ops), net_comparisons=net.comparisons,
                         sass_minmax=minmax, sass_minmax_per_op=minmax / len(net.ops),
                         sass_per_pixel_comparison=minmax / (net.comparisons * LANES))
        kernels[f"median_net_kernel<{k}>"] = entry
    return dict(intrinsics=intrinsics, rates=rates, sm_clock_mhz=clock, kernels=kernels)


def median_mode(card, lib_path):
    """--median: K7's checks and timing (median_checks, median_timing) on
    the first 256 frames of the slice's clip and on the small clip, its
    SASS (median_sass), one JSON line; then phase 7g (median_route) on the
    512-frame clip, a second line."""
    from refimpl.synthetic import multi_blob_clip
    from tpuva_torch.graph import config
    from tpuva_torch.ops.fused_segment import fused_segment
    from tpuva_torch.ops.median import median_u8
    from tpuva_torch.ops.wide import blur_u8, morph_u8
    from tpuva_torch.track.scan import track_scan

    clip, _alive, _truth, plate = multi_blob_clip(1080, 1920, 512, n_blobs=6, radius=16,
                                                  births_deaths=False, noise_sigma=2.0)
    small = multi_blob_clip(160, 240, 16, n_blobs=2, radius=46.0, noise_sigma=2.0, seed=7)[0]
    frames = torch.from_numpy(clip[:256]).to("cuda")
    err = {"median_u8": 0.0, "median_u8_hist": 0.0}
    line = median_checks(frames, small, err)
    line.update(median_timing(frames, err, 5))
    line["sass"] = median_sass(lib_path)
    say("median", card=card, max_abs_err=err, **line)
    del frames
    torch.cuda.empty_cache()
    counters = {"fused_segment": (fused_segment, "launches"), "blur_u8": (blur_u8, "launches"),
                "median_u8": (median_u8, "launches"), "track_scan": (track_scan, "launches"),
                "morph_u8": (morph_u8, "launches")}
    say("median_route", card=card, frames=int(clip.shape[0]),
        **median_route(clip, plate, bench_cfg(config, 256), counters))
    return 0


STAGING_BATCHES = 6  # batches a timed staging run moves
STAGING_REPEATS = 3


def cycled(VideoBase, clip, frames, shift=0):
    """A decoder stand-in: a VideoBase of `frames` frames whose get_frame
    returns clip[(i + shift) % T] (VideoBase passed in: the checkout's own)."""
    class Cycled(VideoBase):
        def __init__(self):
            super().__init__(frames, (clip.shape[2], clip.shape[1]), 25.0, False)

        def get_frame(self, index):
            return clip[(index + shift) % clip.shape[0]]

    return Cycled()


def record_feeders(sp):
    """Whether each BatchStager that StreamingPipeline sp makes takes the
    native feeder: a list that grows as sp.run makes them."""
    natives, make = [], sp._make_stager

    def record(source):
        stager = make(source)
        natives.append(stager.native)
        return stager

    sp._make_stager = record
    return natives


def spread(xs):
    """{min, median, max} of a list of numbers, unrounded."""
    return {"min": float(min(xs)), "median": float(np.median(xs)), "max": float(max(xs))}


def staging_timing(clip, plate, card, cfg):
    """Staging per 256-frame 1080p batch and the routes' frames/s, in turns.

    Per batch: BatchStager's Python feeder, its native feeder (the C++
    ring) and a pageable copy (torch.from_numpy(chunk).to(card), what
    process_clip did before it staged through the ring), each moving
    STAGING_BATCHES batches, STAGING_REPEATS times in turns, on two
    sources: the clip in memory (VideoMemory over three copies of it) and
    a decoder stand-in whose get_frame returns a frame (Cycled). A run's
    ms per batch is the time from the stager's construction to the last
    batch ready on the card (the consumer's stream synchronised on every
    batch), over its batches; one warm-up run of each first. Then one
    batch's host copy alone into a pinned slot (a block copy, a numpy copy
    a frame, the native ring's push a frame; 3 after a warm-up). Then
    frames/s of process_clip(use_pallas=True), of the streamed default
    route over the clip in memory with each feeder (the ring forced
    through StreamingPipeline._make_stager) and over a decoder stand-in of
    the clip (the feeder the stager picks): each route once untimed, then
    in turns, twice each, each run's CSV held to REF_CSV_SHA256. In a
    checkout whose stager has no native feeder, its
    entries are null. Returns the staging line's fields."""
    from tpuva_torch.export.csvio import format_rows
    from tpuva_torch.graph.pipeline import process_clip
    from tpuva_torch.graph.streaming import StreamingPipeline
    from tpuva_torch.io.base import VideoBase
    from tpuva_torch.io.memory import VideoMemory
    from tpuva_torch.io.staging import BatchStager

    dev = torch.device("cuda")
    N = cfg.batch
    frames = STAGING_BATCHES * N
    sources = {"memory": VideoMemory(np.concatenate([clip] * -(-frames // clip.shape[0]))[:frames]),
               "decoder": cycled(VideoBase, clip, frames)}
    try:
        BatchStager(sources["memory"], N, device=dev, use_native=True).close()
        native = True
    except NotImplementedError:
        native = False

    def stager_run(video, use_native):
        t0 = time.perf_counter()
        stager = BatchStager(video, N, queue_depth=3, device=dev, use_native=use_native)
        ready = []
        try:
            for _n, _b in stager:
                torch.cuda.current_stream().synchronize()
                ready.append(time.perf_counter())
        finally:
            stager.close()
        if len(ready) != STAGING_BATCHES:
            raise AssertionError(f"the stager gave {len(ready)} batches")
        return 1e3 * (ready[-1] - t0) / len(ready), [1e3 * (b - a) for a, b in zip(ready, ready[1:])]

    def pageable_run(video):
        t0 = time.perf_counter()
        for start in range(0, frames, N):
            chunk = np.stack([video.get_frame(start + i) for i in range(N)]) \
                if not isinstance(video, VideoMemory) else video.data[start:start + N]
            torch.from_numpy(chunk).to(dev)
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / STAGING_BATCHES, []

    methods = {"python": lambda v: stager_run(v, False), "pageable": pageable_run}
    if native:
        methods["native"] = lambda v: stager_run(v, True)
    out = {"card": card, "batch": N, "shape": list(clip.shape[1:]),
           "batches_a_run": STAGING_BATCHES, "repeats": STAGING_REPEATS,
           "native_feeder": native}
    for src, video in sources.items():
        for run in methods.values():
            run(video)  # warm-up: pinned buffers, threads, the host library
        runs = {m: [] for m in methods}
        intervals = {m: [] for m in methods}
        order = list(methods)
        for r in range(STAGING_REPEATS):
            for m in (order if r % 2 == 0 else order[::-1]):
                ms, iv = methods[m](video)
                runs[m].append(ms)
                intervals[m] += iv
        for m in ("python", "native", "pageable"):
            key = f"{src}_{m}_ms_per_batch"
            out[key] = dict(spread(runs[m]), runs=runs[m]) if m in runs else None
            if intervals.get(m):
                out[f"{src}_{m}_interval_ms"] = spread(intervals[m])
    # one batch's host copy alone, into a pinned slot (no copy to the card):
    # one block copy, a numpy copy a frame, the native ring's push a frame
    slot = torch.empty((N,) + clip.shape[1:], dtype=torch.uint8, pin_memory=True)
    host = {"block": [], "numpy_per_frame": [], "native_per_frame": []}
    ring = None
    if native:
        from tpuva_torch.io.native import NativeBatcher

        ring = NativeBatcher(clip.shape[1:], N, [slot])
    for _ in range(4):
        t0 = time.perf_counter()
        np.copyto(slot.numpy(), clip[:N])
        host["block"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for i in range(N):
            slot.numpy()[i] = clip[N + i]
        host["numpy_per_frame"].append(1e3 * (time.perf_counter() - t0))
        if ring is not None:
            t0 = time.perf_counter()
            for i in range(N):
                ring.push(clip[i])
            host["native_per_frame"].append(1e3 * (time.perf_counter() - t0))
            s_, n_ = ring.pop()
            ring.release(s_)
    if ring is not None:
        ring.close()
        ring.destroy()
    out["host_copy_ms"] = {k: (spread(v[1:]) if v else None) for k, v in host.items()}
    del sources, slot

    def force_native(sp):
        sp._make_stager = lambda source: BatchStager(  # noqa: E731
            source, N, queue_depth=sp.queue_depth, device=dev, use_native=True)
        return sp

    def route(name):
        if name == "process_clip":
            run = lambda: process_clip(clip, cfg, background0=plate,  # noqa: E731
                                       max_components=MAX_COMPONENTS, use_pallas=True,
                                       device="cuda")[0]
        else:
            sp = StreamingPipeline(cfg, max_components=MAX_COMPONENTS)
            if name == "stream_native":
                force_native(sp)
            video = (cycled(VideoBase, clip, clip.shape[0]) if name == "stream_decoder"
                     else VideoMemory(clip))
            run = lambda: sp.run(video, background0=plate)  # noqa: E731
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = run()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        if hashlib.sha256(format_rows(rows).encode()).hexdigest() != REF_CSV_SHA256:
            raise AssertionError(f"{name} rows differ from the reference's")
        return clip.shape[0] / s

    names = (["process_clip", "stream_python"] + (["stream_native"] if native else [])
             + ["stream_decoder"])
    for name in names:
        route(name)  # untimed: each route's first run of the call
    fps = {n: [] for n in names}
    for name in names + names[::-1]:
        fps[name].append(route(name))
    out["process_clip_use_pallas_fps"] = fps["process_clip"]
    out["stream_default_python_fps"] = fps["stream_python"]
    out["stream_default_native_fps"] = fps.get("stream_native")
    out["stream_default_decoder_fps"] = fps["stream_decoder"]
    probe = BatchStager(cycled(VideoBase, clip, clip.shape[0]), N, device=dev)
    out["stream_decoder_feeder"] = "native" if getattr(probe, "native", False) else "python"
    probe.close()
    out["route_order"] = names + names[::-1]
    return out


# the kernels that take a stream axis (the kernels line marks them)
STREAM_AXIS = ("fused_segment", "fused_segment_padded_occ", "fused_segment_diff",
               "fused_segment_streams", "track_scan", "track_scan_streams")
MS_STREAMS = 8  # config 5: concurrent camera streams
MS_SHIFT = 64  # frames stream s's clip is shifted by, cyclically
MS_K1_FRAMES = 16  # frames a stream in K1's stream-axis check
MS_REPEATS = 5  # timed repeats of K1 and K5 at S streams and as S single launches


def spread_runs(xs):
    return dict(spread(xs), runs=[float(x) for x in xs])


def multistream_phase(clip, plate, card, cfg, err):
    """Phase 7d: config 5, MS_STREAMS streams of the 1080p bench clip
    through MultiStreamPipeline on the card (stream s the clip shifted by
    MS_SHIFT * s frames). Returns (the phase line's fields, the kernels
    line's times, launches and bounds of K1's and K5's stream axis)."""
    import threading

    from tpuva_torch.dist import (
        MultiStreamPipeline, init_multistream_carry, make_multistream_processor,
        merge_stream_rows,
    )
    from tpuva_torch.export.csvio import format_rows
    from tpuva_torch.graph.pipeline import _diff_kwargs, _front_end_kwargs
    from tpuva_torch.graph.streaming import StreamingPipeline
    from tpuva_torch.io.base import VideoBase
    from tpuva_torch.io.memory import VideoMemory
    from tpuva_torch.io.staging import BatchStager
    from tpuva_torch.ops import connected_components_with_stats
    from tpuva_torch.ops.ccl import label_components_tiled, label_stats, root_stats
    from tpuva_torch.ops.fused_segment import fused_segment, fused_segment_plain
    from tpuva_torch.ops.label import extract_detections
    from tpuva_torch.scenes import DET_KINDS, det_sequence
    from tpuva_torch.track.scan import track_scan, track_scan_plain
    from tpuva_torch.track.table import TrackState, init_track_state

    t_phase = time.time()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    S, N = MS_STREAMS, cfg.batch
    T, H, W = clip.shape
    kw, diff_kw = _front_end_kwargs(cfg), _diff_kwargs(cfg)
    t_kw = dict(max_dist=cfg.track.max_dist, death_patience=cfg.track.death_patience,
                assigner=cfg.track.assigner)
    counters = {"k1": (fused_segment, "launches"), "k1_streams": (fused_segment, "stream_launches"),
                "k5": (track_scan, "launches"), "k5_streams": (track_scan, "stream_launches"),
                "k3": (label_components_tiled, "launches"),
                "k6_occ": (root_stats, "occ_launches"), "k2": (label_stats, "launches")}

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    def videos():
        """Stream 0 the clip in memory, stream s >= 1 a decoder stand-in
        of it shifted by MS_SHIFT * s frames."""
        return [VideoMemory(clip)] + [cycled(VideoBase, clip, T, MS_SHIFT * s)
                                      for s in range(1, S)]

    # each stream its own plate: stream 0 the clip's (REF_CSV_SHA256 pins
    # its rows), stream s >= 1 the first frame of its own sequence
    plates = np.stack([plate.astype(np.float32)]
                      + [clip[MS_SHIFT * s].astype(np.float32) for s in range(1, S)])
    out = {"card": card, "streams": S, "shape": [H, W], "batch": N, "frames_a_stream": T,
           "shift_frames": MS_SHIFT}

    # K1 with the stream axis against its plain version on the card: S
    # streams of MS_K1_FRAMES frames, distinct plates, both emits, one
    # seed flag for all and one a stream
    k1_frames = [torch.from_numpy(np.ascontiguousarray(
        clip[MS_SHIFT * s:MS_SHIFT * s + MS_K1_FRAMES])).to(dev) for s in range(S)]
    k1_bg = torch.from_numpy(plates).to(dev)
    mixed = torch.tensor([s % 3 == 1 for s in range(S)], device=dev)
    for emit, opts in (("mask", kw), ("diff", diff_kw)):
        for seed in (False, mixed):
            check_equal(err, "fused_segment_streams",
                        zip(("masks", "bg"), fused_segment(k1_frames, k1_bg, seed_bg=seed, **opts),
                            fused_segment_plain(k1_frames, k1_bg, seed_bg=seed, **opts)),
                        f"{S} streams x {MS_K1_FRAMES} frames, {emit}, "
                        f"seed {'mixed' if seed is mixed else seed}")
    del k1_frames
    # K5 with the stream axis against its plain version: a det_sequence
    # stream each (kinds and seeds differ), tables at and past the
    # register kernel's 32 x 32, from a fresh table and from its result
    for T5, D5, F in ((16, 8, 128), (32, 32, 32), (33, 40, 32)):
        seqs = [det_sequence(DET_KINDS[s % len(DET_KINDS)], D5, frames=2 * F, seed=s + T5)
                for s in range(S)]
        dets = torch.from_numpy(np.stack([d for d, _ in seqs]))
        valid = torch.from_numpy(np.stack([v for _, v in seqs]))
        state = TrackState(*(torch.stack(x) for x in zip(*[init_track_state(T5, "cpu")] * S)))
        frame0 = torch.arange(S, dtype=torch.int32) * 1000
        for half in range(2):
            sl = slice(half * F, (half + 1) * F)
            got = check_track_scan(err, state, dets[:, sl], valid[:, sl], frame0 + half * F,
                                   f"{S} streams, table {T5} x {D5}, frames {sl}",
                                   kernel="track_scan_streams", **t_kw)
            state = TrackState(*(x.cpu() for x in got[0]))
    out["k1_k5_streams_bit_equal"] = True

    # MultiStreamPipeline: an untimed run (its launches counted), then two timed
    msp_kw = dict(max_components=MAX_COMPONENTS)
    queue_depth = 3  # MultiStreamPipeline's default
    out["pinned_bytes"] = S * (queue_depth + 1) * N * H * W

    def ms_run(**extra):
        msp = MultiStreamPipeline(cfg, S, queue_depth=queue_depth, **msp_kw, **extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, merged = msp.run(videos(), background0=plates)
        torch.cuda.synchronize()
        return rows, merged, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset()
    rows, merged, first_s = ms_run()
    run_counts = counts()
    out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    steps = -(-T // N)
    if (run_counts["k1"], run_counts["k1_streams"], run_counts["k5"], run_counts["k5_streams"],
            run_counts["k3"], run_counts["k6_occ"], run_counts["k2"]) != (steps,) * 6 + (0,):
        raise AssertionError(f"multistream run launches ({steps} steps): {run_counts}")
    out["run_launches"] = run_counts
    fps = [S * T / ms_run()[2] for _ in range(2)]
    out["fps_all_streams"] = fps
    out["first_run_fps"] = S * T / first_s
    # every stream against the single-stream streamed default route on it
    singles = [StreamingPipeline(cfg, **msp_kw).run(v, background0=plates[s])
               for s, v in enumerate(videos())]
    for s in range(S):
        if rows[s] != singles[s]:
            raise AssertionError(f"stream {s}: multistream rows differ from its single-stream run")
    if hashlib.sha256(format_rows(rows[0]).encode()).hexdigest() != REF_CSV_SHA256:
        raise AssertionError("stream 0's rows differ from the OpenCV reference's")
    if merged != merge_stream_rows(singles, with_stream=True):
        raise AssertionError("merged rows differ from merge_stream_rows of the single runs")
    out["rows_a_stream"] = [len(r) for r in rows]
    out["stream0_csv_sha256_equals_reference"] = True
    out["streams_equal_single_stream_route"] = True
    out["merged_equal"] = True
    # stopped after its first step (a checkpoint each step), then resumed
    ckpt = os.path.join(OUT_DIR, "ms_ckpt.npz")
    if os.path.exists(ckpt):
        os.unlink(ckpt)
    MultiStreamPipeline(cfg, S, checkpoint_path=ckpt, checkpoint_every=1, **msp_kw).run(
        [v[:N] for v in videos()], background0=plates)
    resumed, resumed_merged = MultiStreamPipeline(
        cfg, S, checkpoint_path=ckpt, checkpoint_every=1, **msp_kw).run(videos(),
                                                                          background0=plates)
    if resumed != rows or resumed_merged != merged:
        raise AssertionError("the stopped-and-resumed multistream run differs")
    out["resumed_equal"] = True
    del singles, resumed, resumed_merged

    # one step on batches already on the card: its launches, its device ms
    batches = [torch.from_numpy(np.take(clip, (np.arange(N) + MS_SHIFT * s) % T, axis=0)).to(dev)
               for s in range(S)]
    fn = make_multistream_processor(cfg, S, **msp_kw)
    carry0 = init_multistream_carry(cfg, H, W, S, background0=plates)
    reset()
    fn(carry0, batches)
    torch.cuda.synchronize()
    step_counts = counts()
    if (step_counts["k1"], step_counts["k1_streams"], step_counts["k5"],
            step_counts["k5_streams"], step_counts["k3"], step_counts["k6_occ"]) != (1,) * 6:
        raise AssertionError(f"one multistream step's launches: {step_counts}")
    out["step_launches"] = step_counts
    out["step_device_ms"] = spread_runs([once_ms(lambda: fn(carry0, batches))
                                         for _ in range(3)])
    # K1 and K5 at S streams against S single-stream launches, in turns
    # after one untimed run each, bit-equal first
    one_k1 = lambda: [fused_segment(batches[s], carry0.bg[s], **kw) for s in range(S)]  # noqa: E731
    all_k1 = lambda: fused_segment(batches, carry0.bg, **kw)  # noqa: E731
    masks, bg_last = all_k1()
    # against the plain version at this shape (S * N frames, offsets past
    # 2^31), a stream at a time to keep check_equal's doubles small; then
    # against each stream's own launch as a second witness
    plain = []
    out["k1_streams_plain_ms"] = once_ms(
        lambda: plain.append(fused_segment_plain(batches, carry0.bg, **kw)))
    for s in range(S):
        check_equal(err, "fused_segment_streams",
                    [("masks", masks[s], plain[0][0][s]), ("bg", bg_last[s], plain[0][1][s])],
                    f"stream {s} of {S} against the plain version, batch {N}")
    del plain
    for s, (m1, b1) in enumerate(one_k1()):
        check_equal(err, "fused_segment_streams", [("masks", masks[s], m1), ("bg", bg_last[s], b1)],
                    f"stream {s} of {S} against its own launch, batch {N}")
    stats = connected_components_with_stats(masks.flatten(0, 1), MAX_COMPONENTS,
                                            compute_bbox=False, compute_labels=False)
    del masks
    dets, _n, valid, _sums = extract_detections(stats, cfg.segment.min_area, cfg.segment.max_blobs)
    D = cfg.segment.max_blobs
    dets, valid = dets.reshape(S, N, D, 3), valid.reshape(S, N, D)
    check_track_scan(err, carry0.track, dets, valid, carry0.frame_idx,
                     f"{S} streams, the step's detections, batch {N}",
                     kernel="track_scan_streams", **t_kw)
    one_k5 = lambda: [track_scan(TrackState(*(x[s] for x in carry0.track)), dets[s],  # noqa: E731
                                 valid[s], carry0.frame_idx[s], **t_kw) for s in range(S)]
    all_k5 = lambda: track_scan(carry0.track, dets, valid, carry0.frame_idx, **t_kw)  # noqa: E731
    timed = {"k1_streams": all_k1, "k1_single_launches": one_k1,
             "k5_streams": all_k5, "k5_single_launches": one_k5}
    ms = {name: [] for name in timed}
    for name, fn_t in timed.items():
        once_ms(fn_t)  # untimed
    order = list(timed)
    for r in range(MS_REPEATS):
        for name in (order if r % 2 == 0 else order[::-1]):
            ms[name].append(once_ms(timed[name]))
    for name, xs in ms.items():
        out[f"{name}_ms"] = spread_runs(xs)
    out["k5_streams_plain_ms"] = once_ms(lambda: track_scan_plain(
        carry0.track, dets, valid, carry0.frame_idx, **t_kw))
    px = S * N * H * W
    bounds = {
        # every stream's frames read, masks written, background read and
        # written once
        "fused_segment_streams": bound(2 * px + S * 2 * 4 * H * W, k1_ops_per_px(kw) * px),
        # detections and flags read, rows and flags written, each table
        # read and written once
        "track_scan_streams": bound(dets.numel() * 4 + valid.numel() * (1 + 20 + 1)
                                    + S * 2 * (cfg.track.max_tracks * 17 + 4),
                                    S * k5_ops(cfg.track.max_tracks, D, N)),
    }
    del batches, carry0, dets, valid, stats, fn

    # staging: one stager alone, then S at once (the pipeline's feeders, a
    # consumer thread and CUDA stream each), in turns: ms a batch each
    def stage(k):
        res, errs = [None] * k, []

        def drain(i):
            try:
                stream = torch.cuda.Stream(dev)
                with torch.cuda.stream(stream):
                    t0 = time.perf_counter()
                    st = BatchStager(cycled(VideoBase, clip, STAGING_BATCHES * N, MS_SHIFT * i), N,
                                     queue_depth=queue_depth, device=dev)
                    n = 0
                    try:
                        for _n, _b in st:
                            stream.synchronize()
                            n += 1
                    finally:
                        st.close()
                res[i] = 1e3 * (time.perf_counter() - t0) / n
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)

        threads = [threading.Thread(target=drain, args=(i,)) for i in range(k)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errs:
            raise errs[0]
        return res, time.perf_counter() - t0

    stage(1)
    stage(S)  # warm-up: pinned slots, threads
    alone, together, rates = [], [], []
    for k in (1, S, S, 1):
        res, wall = stage(k)
        (alone if k == 1 else together).extend(res)
        if k == S:
            rates.append(S * STAGING_BATCHES * N * H * W / wall / 1e9)
    out["staging_batches_a_run"] = STAGING_BATCHES
    out["staging_one_stager_ms_a_batch"] = spread_runs(alone)
    out["staging_each_of_s_stagers_ms_a_batch"] = spread_runs(together)
    out["staging_s_stagers_gb_per_s"] = rates
    # what sets that pace: the S host copies alone (a thread each, a batch
    # of the clip into its own pinned slot, nothing sent to the card), and
    # the link alone (S filled pinned slots to the card), 3 runs each
    # after one untimed
    slots = [torch.empty((N, H, W), dtype=torch.uint8, pin_memory=True) for _ in range(S)]
    dst = [torch.empty((N, H, W), dtype=torch.uint8, device=dev) for _ in range(S)]
    nbytes = S * N * H * W

    def host_copies():
        threads = [threading.Thread(target=np.copyto, args=(
            slots[i].numpy(), clip[32 * i % (T - N):32 * i % (T - N) + N])) for i in range(S)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return nbytes / (time.perf_counter() - t0) / 1e9

    def link():
        return nbytes / once_ms(lambda: [d.copy_(h, non_blocking=True)
                                         for d, h in zip(dst, slots)]) / 1e6

    out["host_copies_alone_gb_per_s"] = [host_copies() for _ in range(4)][1:]
    out["link_alone_gb_per_s"] = [link() for _ in range(4)][1:]
    del slots, dst
    out["seconds"] = round(time.time() - t_phase, 1)
    kernels = {
        "times": {"fused_segment_streams": (float(np.median(ms["k1_streams"])),
                                            out["k1_streams_plain_ms"]),
                  "track_scan_streams": (float(np.median(ms["k5_streams"])),
                                         out["k5_streams_plain_ms"])},
        "launches": {"fused_segment_streams": run_counts["k1_streams"],
                     "track_scan_streams": run_counts["k5_streams"]},
        "bounds": bounds,
    }
    return out, kernels


SPATIAL_BANDS = 4  # phase 7f: the ('space',) mesh, four bands on the one card
SPATIAL_BANDS_ODD = 8  # and eight: 135 rows, odd bands' first rows odd
SPATIAL_STREAMS = 2  # phase 7f: the ('stream',) mesh on the one card
KB_KERNELS = ("band_labels", "recon_edges", "recon_min", "piece_table", "piece_sums")


def kb_against_plain(err, mask, n, C, where):
    """KB on the n row bands of mask (N, H, W) uint8 on the card, each band
    read in place, against the plain versions on the same card, round by
    round until no band changes: labels, the root lists (sorted), piece
    values at the roots, snapshots, flags, tables and sums bit-equal, the
    max abs difference folded into err. Returns (kernel pieces, plain
    pieces, the last round's kernel snapshots, rounds)."""
    from tpuva_torch.ops import band_ccl as bc

    N, H, W = mask.shape
    Hb = H // n
    sent = ((H + 1) // 2) * ((W + 1) // 2) * 4

    def same(name, k, p, what):
        pairs = [("labels", k.lab, p.lab), ("nroots", k.nroots, p.nroots)]
        for f in range(N):
            r = int(p.nroots[f])
            kr = k.roots[f, :r].sort().values
            pairs += [(f"roots {f}", kr, p.roots[f, :r]),
                      (f"values {f}", k.val[f, kr.long()], p.val[f, kr.long()])]
        check_equal(err, name, pairs, f"{where}, {what}")

    K = [bc.band_labels(mask, b * Hb, Hb, b * Hb, sent) for b in range(n)]
    P = [bc.band_labels_plain(mask[:, b * Hb:(b + 1) * Hb], b * Hb, sent) for b in range(n)]
    for b in range(n):
        same("band_labels", K[b], P[b], f"band {b}")
    rounds = 0
    while True:
        rounds += 1
        ek = [bc.recon_edges(k) for k in K]
        ep = [bc.recon_edges_plain(p) for p in P]
        flags = []
        for b in range(n):
            check_equal(err, "recon_edges", [("snapshot", ek[b], ep[b])],
                        f"{where}, round {rounds}, band {b}")
            fk = bc.recon_min(K[b], ek[b], ek[b - 1][:, 1] if b else None,
                              ek[b + 1][:, 0] if b < n - 1 else None)
            fp = bc.recon_min_plain(P[b], ep[b], ep[b - 1][:, 1] if b else None,
                                    ep[b + 1][:, 0] if b < n - 1 else None)
            check_equal(err, "recon_min", [("flag", fk, fp)], f"{where}, round {rounds}")
            same("recon_min", K[b], P[b], f"round {rounds}, band {b}")
            flags.append(int(fk))
        if not any(flags):
            break
    for b in range(n):
        t = bc.piece_table(K[b], C)
        check_equal(err, "piece_table", [("table", t, bc.piece_table_plain(P[b], C))],
                    f"{where}, band {b}")
        check_equal(err, "piece_sums", [("sums", bc.piece_sums(K[b], t),
                                         bc.piece_sums_plain(P[b], t))], f"{where}, band {b}")
    return K, P, ek, rounds


def kb_timing(mask, n, C, K, P, ek):
    """Each KB kernel's ms and its plain version's (CUDA events) on band 1
    of n (an interior band, as the main path gives it), with its bound
    from this run's data: {name: {ms, plain_ms, bound_ms, bound_by,
    library_ms}}. The round is the last one (no piece falls: the confirm
    round every batch ends with)."""
    from tpuva_torch.ops import band_ccl as bc

    N, H, W = mask.shape
    Hb = H // n
    k, p = K[1], P[1]
    sent, y0 = k.sent, k.y0
    px = N * Hb * W
    roots = int(k.nroots.sum())
    edge_fg = int((k.lab[:, [0, -1]] != sent).sum())
    hits = sum(int(((k.lab[:, e] != sent) & (bc._adj(nb, sent) < ek[1][:, e])).sum())
               for e, nb in ((0, ek[0][:, 1]), (-1, ek[2][:, 0])))
    table = bc.piece_table(k, C)
    # the band's pixels in K3's occupied strips (2 rows x 256 columns)
    Hbk, S = k.occ.shape[1:]
    rows = torch.tensor([sum(0 <= y - k.r0 < Hb for y in (2 * r, 2 * r + 1)) for r in range(Hbk)])
    cols = torch.tensor([min(256, W - 256 * s) for s in range(S)])
    occ_px = int((k.occ.cpu().long() * rows[:, None] * cols[None, :]).sum())
    runs = {
        # the mask read, the int32 labels written, a root's value and list
        # entry; K3's operations a pixel
        "band_labels": (lambda: bc.band_labels(mask, Hb, Hb, y0, sent),
                        lambda: bc.band_labels_plain(mask[:, Hb:2 * Hb], y0, sent),
                        5 * px + 8 * roots + 4 * N, CCL_OPS_PER_PX * px, 5),
        # two label rows read, the foreground ones' values, two rows written
        "recon_edges": (lambda: bc.recon_edges(k), lambda: bc.recon_edges_plain(p),
                        16 * N * W + 4 * edge_fg, 2 * N * W, 50),
        # two label rows, the band's two snapshot rows, the row above it
        # and the row below it read; a value written a hit
        "recon_min": (lambda: bc.recon_min(k, ek[1], ek[0][:, 1], ek[2][:, 0]),
                      lambda: bc.recon_min_plain(p, ek[1], ek[0][:, 1], ek[2][:, 0]),
                      24 * N * W + 4 * hits, 4 * edge_fg, 50),
        # the root list and their values read, the table written
        "piece_table": (lambda: bc.piece_table(k, C), lambda: bc.piece_table_plain(p, C),
                        4 * N + 8 * roots + 4 * N * C, 4 * roots, 50),
        # the occupancy, the occupied strips' labels and their pieces'
        # values read, the table read and the sums written
        "piece_sums": (lambda: bc.piece_sums(k, table), lambda: bc.piece_sums_plain(p, table),
                       k.occ.numel() + 4 * occ_px + 4 * roots + 4 * N * C + 24 * N * C,
                       CCL_OPS_PER_PX * occ_px, 20),
    }
    out = {}
    for name, (fn, plain, nbytes, nops, reps) in runs.items():
        b = bound(nbytes, nops)
        out[name] = {"ms": cuda_ms(fn, reps), "plain_ms": cuda_ms(plain, 1, warm=False),
                     "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    out["shape"] = {"band": 1, "bands": n, "frames": N, "rows": Hb, "W": W, "roots": roots,
                    "occupied_px": occ_px, "edge_fg_px": edge_fg, "recon_hits": hits, "C": C}
    return out


def spatial_phase(clip, plate, card, cfg, err):
    """Phase 7f: the multi-card half of dist/ on the one card. K1 on the
    band shapes against its plain version; the band CCL's kernels KB
    against their plain versions on the clip's first batch at the 4- and
    8-band shapes (270 and 135 rows), round by round, and each one timed;
    SpatialStreamPipeline on a mesh of SPATIAL_BANDS bands that all lie on
    cuda:0 over the clip (fixed and Otsu thresholds, launches counted
    around each run: KB-labels and KB-table a band a batch, KB-recon's two
    launches a band a round), the fixed run again with KB's plain versions
    in the processor (the same rows and rounds), an eight-band run, a
    checkpoint of the band run resumed on the single-card
    StreamingPipeline; the ('stream',) mesh of SPATIAL_STREAMS streams on
    cuda:0 against the stream-axis route. Returns (the phase line's
    fields, KB's entries of the kernels line)."""
    import tpuva_torch.dist.spatial as dsp
    from tpuva_torch.dist import (
        MultiStreamPipeline, SpatialStreamPipeline, make_space_mesh, make_spatial_processor,
        make_stream_mesh,
    )
    from tpuva_torch.dist.spatial import _halo_rows
    from tpuva_torch.ops import band_ccl as bc
    from tpuva_torch.export.csvio import format_rows
    from tpuva_torch.graph import config
    from tpuva_torch.graph.pipeline import (
        _diff_kwargs, _front_end_kwargs, _morph_stages, init_carry,
    )
    from tpuva_torch.graph.streaming import StreamingPipeline
    from tpuva_torch.io.base import VideoBase
    from tpuva_torch.io.memory import VideoMemory
    from tpuva_torch.ops.ccl import label_components_tiled, label_stats, root_stats
    from tpuva_torch.ops.filters import histogram_u8, histogram_u8_plain
    from tpuva_torch.ops.fused_segment import fused_segment, fused_segment_plain
    from tpuva_torch.ops.wide import morph_plan, morph_u8, open_close_steps
    from tpuva_torch.track.scan import track_scan

    t_phase = time.time()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    T, H, W = clip.shape
    n, N = SPATIAL_BANDS, cfg.batch
    Hb, halo = H // n, _halo_rows(cfg)
    otsu_cfg = bench_cfg(config, N, threshold="otsu")
    counters = {"k1": (fused_segment, "launches"), "k4": (histogram_u8, "launches"),
                "k5": (track_scan, "launches"), "k3": (label_components_tiled, "launches"),
                "k6": (root_stats, "launches"), "k2": (label_stats, "launches"),
                "k1m": (morph_u8, "launches"),
                **{name: (getattr(bc, name), "launches") for name in KB_KERNELS}}

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    out = {"card": card, "bands": n, "mesh": "4 bands sharing one card", "shape": [H, W],
           "batch": N, "halo_rows": halo}
    # the band path's kernels at the shapes it gives them, on the clip's
    # first batch: K1 and K1-diff on an edge band (its rows and the halo
    # on one side) and an interior one (the halo on both); K4 on the
    # band's interior rows of K1-diff's magnitudes, the strided slice
    # make_spatial_processor histograms
    shapes = {"edge": (0, Hb + halo, 0), "interior": (Hb - halo, 2 * Hb + halo, halo)}
    for name, (lo, hi, top) in shapes.items():
        frames = torch.from_numpy(np.ascontiguousarray(clip[:N, lo:hi])).to(dev)
        bg0 = torch.from_numpy(np.ascontiguousarray(plate[lo:hi], np.float32)).to(dev)
        where = f"{name} band, {tuple(frames.shape)}"
        kw = _front_end_kwargs(cfg)
        check_equal(err, "fused_segment", zip(("masks", "bg"), fused_segment(frames, bg0, **kw),
                                              fused_segment_plain(frames, bg0, **kw)), where)
        kw = _diff_kwargs(otsu_cfg)
        du8, bg_diff = fused_segment(frames, bg0, **kw)
        check_equal(err, "fused_segment_diff", zip(("magnitudes", "bg"), (du8, bg_diff),
                                                   fused_segment_plain(frames, bg0, **kw)), where)
        rows = du8[:, top:top + Hb]
        check_equal(err, "histogram_u8",
                    [("counts", histogram_u8(rows), histogram_u8_plain(rows).to(torch.float32))],
                    f"{name} band's interior rows, {tuple(rows.shape)}")
        del frames, bg0, du8, bg_diff, rows
    out["k1_band_shapes"] = {k: [N, hi - lo, W] for k, (lo, hi, _) in shapes.items()}
    out["k4_band_shape"] = [N, Hb, W]
    out["band_kernels_bit_equal"] = True

    # KB against its plain versions on the clip's first batch's masks (the
    # single-card front end's: each band's rows of them), read in place at
    # the 4- and 8-band shapes, then each kernel timed on band 1 of 4
    frames = torch.from_numpy(np.ascontiguousarray(clip[:N])).to(dev)
    bg0 = torch.from_numpy(plate.astype(np.float32)).to(dev)
    masks, _bg = fused_segment(frames, bg0, **_front_end_kwargs(cfg))
    del frames, bg0, _bg
    kb = {}
    for bands in (n, SPATIAL_BANDS_ODD):
        K, P, ek, rounds = kb_against_plain(err, masks, bands, MAX_COMPONENTS,
                                            f"the clip's first batch on {bands} bands")
        out[f"kb_bit_equal_{bands}_bands"] = {"rows": H // bands, "rounds": rounds,
                                              "pieces": [int(k.nroots.sum()) for k in K]}
        if bands == n:
            kb = kb_timing(masks, n, MAX_COMPONENTS, K, P, ek)
        del K, P, ek
    out["kb_timing"] = kb
    del masks
    torch.cuda.empty_cache()

    mesh = make_space_mesh(n, [dev] * n)
    sp_kw = dict(max_components=MAX_COMPONENTS)
    plain_kb = dict(band_labels=lambda m, row0, rows, y0, sent: bc.band_labels_plain(
        m[:, row0:row0 + rows], y0, sent), recon_edges=bc.recon_edges_plain,
        recon_min=bc.recon_min_plain, piece_table=bc.piece_table_plain,
        piece_sums=bc.piece_sums_plain)

    @contextlib.contextmanager
    def on_plain_kb(plain=True):
        """The band processor with KB's plain versions on the card in its
        kernels' place (plain=False: as it is)."""
        saved = {k: getattr(dsp, k) for k in plain_kb}
        if plain:
            for k, f in plain_kb.items():
                setattr(dsp, k, f)
        try:
            yield
        finally:
            for k, f in saved.items():
                setattr(dsp, k, f)

    # the band runs, fixed threshold and Otsu on 4 bands, the fixed one
    # again on KB's plain versions and on 8 bands: launches counted around
    # each
    runs = (("fixed", cfg, REF_CSV_SHA256, n, False),
            ("otsu", otsu_cfg, REF_OTSU_CSV_SHA256, n, False),
            ("fixed_plain_kb", cfg, REF_CSV_SHA256, n, True),
            ("fixed_8_bands", cfg, REF_CSV_SHA256, SPATIAL_BANDS_ODD, False))
    for name, c, ref, bands, plain in runs:
        sp = SpatialStreamPipeline(c, bands, mesh=[dev] * bands, **sp_kw)
        with on_plain_kb(plain):
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            rows = sp.run(VideoMemory(clip), background0=plate)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        got = counts()
        batches = -(-T // N) + 1  # and the warm-up's zero batch
        rounds = sum(sp.recon_rounds) + 1  # the warm-up's zero batch: one round
        otsu = c is otsu_cfg
        # the Otsu tail on each band: K1m, a launch a morph_plan group
        tail_groups = len(morph_plan(H // bands, W, open_close_steps(_morph_stages(c))))
        want = dict(k1=bands * batches, k4=bands * batches if otsu else 0, k5=batches, k3=0,
                    k6=0, k2=0, k1m=bands * batches * tail_groups if otsu else 0,
                    band_labels=bands * batches, recon_edges=bands * rounds,
                    recon_min=bands * rounds, piece_table=bands * batches,
                    piece_sums=bands * batches)
        if plain:
            want.update({k: 0 for k in KB_KERNELS})
        if got != want:
            raise AssertionError(f"band run ({name}) launches, {batches} batches: {got}, "
                                 f"want {want}")
        if hashlib.sha256(format_rows(rows).encode()).hexdigest() != ref:
            raise AssertionError(f"band run ({name}): CSV differs from the reference's")
        if sp.overflow_frames:
            raise AssertionError(f"band run ({name}): stats_overflow on {sp.overflow_frames} frames")
        if plain and list(sp.recon_rounds) != out["fixed_tp_recon_rounds"]:
            raise AssertionError(f"band run ({name}): tp_recon_rounds {sp.recon_rounds}, on KB "
                                 f"{out['fixed_tp_recon_rounds']}")
        out[f"{name}_rows"] = len(rows)
        out[f"{name}_csv_sha256_equals_reference"] = True
        out[f"{name}_launches"] = got
        out[f"{name}_k1m_launches_a_band_a_batch"] = tail_groups if otsu else 0
        out[f"{name}_tp_recon_rounds"] = list(sp.recon_rounds)
        out[f"{name}_seconds_{bands}_bands_sharing_one_card"] = seconds
        out[f"{name}_stats_overflow_frames"] = sp.overflow_frames
    # a checkpoint after the band run's first batch, resumed on one card
    ckpt = os.path.join(OUT_DIR, "spatial_ckpt.npz")
    if os.path.exists(ckpt):
        os.unlink(ckpt)
    SpatialStreamPipeline(cfg, n, mesh=mesh, checkpoint_path=ckpt, checkpoint_every=1,
                          **sp_kw).run(VideoMemory(clip[:N]), background0=plate)
    resumed = StreamingPipeline(cfg, checkpoint_path=ckpt, checkpoint_every=10**9, **sp_kw).run(
        VideoMemory(clip), background0=plate)
    if hashlib.sha256(format_rows(resumed).encode()).hexdigest() != REF_CSV_SHA256:
        raise AssertionError("the band run's checkpoint resumed on one card: CSV differs")
    out["checkpoint_resumed_on_one_card_equal"] = True
    # one batch's ms between CUDA events (the reconciliation's host reads
    # inside it), on a batch already on the card: 4 bands, on KB and on
    # its plain versions, and 8 bands
    batch = torch.from_numpy(clip[:N]).to(dev)
    carry0 = init_carry(cfg, H, W, plate, device=dev)
    fn8 = make_spatial_processor(cfg, H, W, SPATIAL_BANDS_ODD, mesh=[dev] * SPATIAL_BANDS_ODD,
                                 **sp_kw)
    fn8(carry0, batch)  # untimed
    out["batch_ms_8_bands_sharing_one_card"] = spread_runs(
        [once_ms(lambda: fn8(carry0, batch)) for _ in range(3)])
    fn = make_spatial_processor(cfg, H, W, n, mesh=mesh, **sp_kw)
    with on_plain_kb():
        fn(carry0, batch)  # untimed
        out["batch_ms_4_bands_plain_kb"] = spread_runs(
            [once_ms(lambda: fn(carry0, batch)) for _ in range(2)])
    fn(carry0, batch)  # untimed
    out["batch_ms_4_bands_sharing_one_card"] = spread_runs(
        [once_ms(lambda: fn(carry0, batch)) for _ in range(3)])
    # where that batch's device time goes (torch.profiler, one profiled call):
    # its total, its launches and the eight heaviest kernels
    kernels = kernel_breakdown(lambda: fn(carry0, batch), reps=1)
    out["batch_device_ms"], out["batch_launches"] = device_summary(kernels)
    out["batch_top_kernels"] = dict(list(kernels.items())[:8])
    del fn, fn8, batch, carry0

    # the ('stream',) mesh on the one card against the stream axis
    S = SPATIAL_STREAMS
    plates = np.stack([plate.astype(np.float32)]
                      + [clip[MS_SHIFT * s].astype(np.float32) for s in range(1, S)])

    def videos():
        return [VideoMemory(clip)] + [cycled(VideoBase, clip, T, MS_SHIFT * s)
                                      for s in range(1, S)]

    reset()
    rows_mesh, merged_mesh = MultiStreamPipeline(
        cfg, S, mesh=make_stream_mesh(S, [dev] * S), **sp_kw).run(videos(), background0=plates)
    mesh_counts = counts()
    steps = -(-T // N)
    if (mesh_counts["k1"], mesh_counts["k5"], mesh_counts["k3"]) != (S * steps,) * 3:
        raise AssertionError(f"stream mesh launches ({steps} steps): {mesh_counts}")
    rows_axis, merged_axis = MultiStreamPipeline(cfg, S, mesh=None, **sp_kw).run(
        videos(), background0=plates)
    if rows_mesh != rows_axis or merged_mesh != merged_axis:
        raise AssertionError("the stream mesh's rows differ from the stream axis's")
    if hashlib.sha256(format_rows(rows_mesh[0]).encode()).hexdigest() != REF_CSV_SHA256:
        raise AssertionError("stream mesh: stream 0's CSV differs from the reference's")
    if MultiStreamPipeline(cfg, S, **sp_kw).mesh is not None and torch.cuda.device_count() < S:
        raise AssertionError('mesh="auto" built a stream mesh without a card a stream')
    out["stream_mesh_streams"] = S
    out["stream_mesh_launches"] = mesh_counts
    out["stream_mesh_rows_equal_stream_axis"] = True
    out["stream_mesh_rows_a_stream"] = [len(r) for r in rows_mesh]
    out["seconds"] = round(time.time() - t_phase, 1)
    entries = {name: dict(kb[name], launches=out["fixed_launches"][name]) for name in KB_KERNELS}
    return out, entries


FILTER_FRAMES = 16  # frames of each filter's 1080p check
FILTER_STAGING_BATCHES = 4  # batches a timed stager run moves (phase 7e)


def filter_cases(tf):
    """(name, make(video, device) -> chain, colours) of phase 7e: every
    filter of tpuva_torch.filters at 1080p."""
    return [
        ("crop_rect", lambda v, d: tf.FilterCrop(v, (101, 37, 1601, 999), device=d), (0, 1)),
        ("crop_quadrant", lambda v, d: tf.FilterCrop(v, "lower right", device=d), (0, 1)),
        ("monochrome", lambda v, d: tf.FilterMonochrome(v, device=d), (0, 1)),
        ("resize_960x540", lambda v, d: tf.FilterResize(v, (960, 540), device=d), (0, 1)),
        ("resize_x1.5", lambda v, d: tf.FilterResize(v, (2880, 1620), device=d), (0, 1)),
        ("blur_u8", lambda v, d: tf.FilterBlur(v, 0.0, 5, device=d), (0, 1)),
        ("blur_float", lambda v, d: tf.FilterBlur(tf.FilterNormalize(v, device=d), 1.5, 9),
         (0, 1)),
        ("median_3", lambda v, d: tf.FilterMedian(v, 3, device=d), (0, 1)),
        ("median_5", lambda v, d: tf.FilterMedian(v, 5, device=d), (0, 1)),
        ("normalize", lambda v, d: tf.FilterNormalize(v, 10.0, 200.0, device=d), (0, 1)),
        ("time_difference", lambda v, d: tf.FilterTimeDifference(v, device=d), (0, 1)),
        ("rotate_turn", lambda v, d: tf.FilterRotate(v, turns=1, device=d), (0, 1)),
        ("rotate_7.5", lambda v, d: tf.FilterRotate(v, angle=7.5, device=d), (0, 1)),
        ("warp_affine", lambda v, d: tf.FilterWarpAffine(v, WARP_M, out_size=(1600, 900),
                                                         border_value=7.0, device=d), (0, 1)),
        ("flip", lambda v, d: tf.FilterFlip(v, device=d), (0, 1)),
        ("background", lambda v, d: tf.FilterBackground(v, 0.02, device=d), (0,)),
        ("background_float", lambda v, d: tf.FilterBackground(tf.FilterNormalize(v, device=d),
                                                              0.02), (0,)),
        ("function", lambda v, d: tf.FilterFunction(v, lambda f: 255 - f, device=d), (0, 1)),
    ]


def filters_phase(clip, plate, card, cfg, err):
    """Phase 7e, the filter chain (tpuva_torch.filters) on the card.

    1. Each filter of filter_cases on FILTER_FRAMES frames of the clip at
       1080p, gray and as BGR (three equal channels) where it takes both,
       through iter_batches on the card against the same on the CPU, bit
       for bit; its program's device ms on those frames (CUDA events, after
       the checked run). FilterBlur on uint8 launched K1b once a batch,
       FilterBackground on uint8 K1's diff emit once, FilterBlur on float32
       KG once, FilterBackground on float32 KS's sequential order once; K1b
       and K1's diff emit against their plain versions on the card on those
       inputs.
    2. distance_transform_edt and _sq on K1's masks of those frames (the
       bench config) against the CPU's, the passes of each stage and the
       ms; on one all-foreground frame (+inf everywhere) with its passes;
       analysis.regions.mask_boundary on the masks: one K1m launch, equal
       to its plain version on the card and to the CPU.
    3. The chain route: the clip as BGR through StreamingPipeline(cfg,
       max_components=32).run(FilterMonochrome(VideoMemory(bgr))) on cuda,
       its CSV sha256 == REF_CSV_SHA256, launch counts read around it (K1,
       K3, K6 given K3's occupancy, K5 once a batch, K2 never, the chain's
       program once a batch); then frames/s of the gray route and the
       chain route (each once untimed, then in turns, twice each), the
       stager's ms a batch over FILTER_STAGING_BATCHES batches of each
       (the clip in memory, gray and BGR through the chain; 3 runs each in
       turns, after a warm-up), and the chain program's device ms on a
       staged BGR batch.
    4. A stateful chain, FilterBackground(FilterBlur(FilterMonochrome(
       VideoMemory(bgr)), 5), 0.02), through iter_batches(batch) over the
       clip on cuda: K1b, K1's diff emit and KM once a batch each; its
       first 48 frames equal the CPU chain's on those frames; frames/s.
    5. KM, KW, KR and KE against their plain versions on the card, bit for
       bit (filter_kernel_checks), KG and KS's sequential order likewise
       (float_kernel_checks), then timed (filter_kernel_timing,
       float_kernel_timing).
    Returns (the phase line's fields, its launch counts, the kernels'
    entries of the kernels line)."""
    from tpuva_torch import filters as tf
    from tpuva_torch.analysis.regions import mask_boundary
    from tpuva_torch.export.csvio import format_rows
    from tpuva_torch.graph.streaming import StreamingPipeline
    from tpuva_torch.io.memory import VideoMemory
    from tpuva_torch.io.staging import BatchStager
    from tpuva_torch.ops import color, distance_transform_edt, distance_transform_edt_sq
    from tpuva_torch.ops import resize, warp
    from tpuva_torch.ops.ccl import label_components_tiled, label_stats, root_stats
    from tpuva_torch.ops.distance import edt_kernel, edt_sq_passes
    from tpuva_torch.ops.background import background_scan
    from tpuva_torch.ops.filters import erode, gaussian_blur, gaussian_blur_u8, structuring_element
    from tpuva_torch.ops.fused_segment import fused_segment, fused_segment_plain
    from tpuva_torch.ops.median import median_u8
    from tpuva_torch.ops.wide import blur_u8, morph_u8
    from tpuva_torch.track.scan import track_scan

    dev = torch.device("cuda")
    t_phase = time.time()
    counters = {"fused_segment": (fused_segment, "launches"), "blur_u8": (blur_u8, "launches"),
                "morph_u8": (morph_u8, "launches"), "median_u8": (median_u8, "launches"),
                "ccl_labels": (label_components_tiled, "launches"),
                "ccl_stats": (label_stats, "launches"),
                "root_stats_occ": (root_stats, "occ_launches"),
                "track_scan": (track_scan, "launches"), "chain_program": (tf.run_chain, "runs"),
                "bgr_to_gray": (color.bgr_to_gray, "launches"),
                "resize_linear": (resize.resize_linear, "launches"),
                "warp_affine": (warp.warp_affine, "launches"), "edt": (edt_kernel, "launches"),
                "gaussian_blur_f32": (gaussian_blur, "launches"),
                "background_scan_sequential": (background_scan, "sequential_launches")}

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def counts():
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    out = {"card": card, "frames": FILTER_FRAMES, "shape": list(clip.shape[1:])}
    launches = {}
    gray = clip[:FILTER_FRAMES]
    bgr = np.repeat(gray[..., None], 3, axis=-1)

    # 1. every filter on the card against the CPU, bit for bit
    filter_ms = {}
    for name, make, colours in filter_cases(tf):
        for c in colours:
            data = bgr if c else gray
            key = f"{name}_{'bgr' if c else 'gray'}"
            reset()
            got = list(make(VideoMemory(data), dev).iter_batches(FILTER_FRAMES))
            n = counts()
            ref = list(make(VideoMemory(data), "cpu").iter_batches(FILTER_FRAMES))
            if [k for k, _ in got] != [k for k, _ in ref] or any(
                    a.dtype != b.dtype or not np.array_equal(a, b)
                    for (_k, a), (_j, b) in zip(got, ref)):
                raise AssertionError(f"filter {key}: the card's frames differ from the CPU's")
            kernel = FILTER_KERNELS.get(name)
            if kernel:
                want = 0 if name == "monochrome" and not c else 1  # gray passes through
                if n[kernel] != want or n["chain_program"] != 1:
                    raise AssertionError(f"filter {key} launches: {n}")
                launches[key] = {kernel: n[kernel]}
            chain = make(VideoMemory(data), dev)
            x = torch.from_numpy(data).to(dev)
            carries = chain.init_carries()
            filter_ms[key] = cuda_ms(lambda: tf.run_chain(chain, x, carries), 3)
    out["filters_card_equal_cpu"] = sorted(filter_ms)
    out["filter_card_ms"] = filter_ms
    # K1b and K1's diff emit against their plain versions on the card, on
    # the inputs of FilterBlur (gray, and BGR folded to (3N, H, W)) and
    # FilterBackground (seeded from the first frame)
    x = torch.from_numpy(gray).to(dev)
    folded = torch.from_numpy(bgr).to(dev).permute(0, 3, 1, 2).reshape(-1, *gray.shape[1:])
    for what, frames in (("gray", x), ("bgr folded", folded)):
        check_equal(err, "blur_u8", [("blurred", blur_u8(frames, 5),
                                      gaussian_blur_u8(frames, 5).to(torch.uint8))],
                    f"FilterBlur's input, {what}")
    zero = torch.zeros(gray.shape[1:], dtype=torch.float32, device=dev)
    seed = torch.ones((), dtype=torch.bool, device=dev)
    diff_kw = dict(alpha=0.02, threshold=0.0, emit="diff", seed_bg=seed)
    check_equal(err, "fused_segment_diff",
                zip(("magnitudes", "bg"), fused_segment(x, zero, **diff_kw),
                    fused_segment_plain(x, zero, **diff_kw)), "FilterBackground's input")

    # 2. the EDT on K1's masks, and mask_boundary
    masks, _bg = fused_segment(x, torch.from_numpy(plate.astype(np.float32)).to(dev), **BENCH_KW)
    masks_cpu = masks.cpu()
    for fn in (distance_transform_edt, distance_transform_edt_sq):
        reset()
        got = fn(masks)
        if counts()["edt"] != 1:
            raise AssertionError(f"{fn.__name__}: {counts()['edt']} KE launches")
        if not torch.equal(got.cpu(), fn(masks_cpu)):
            raise AssertionError(f"{fn.__name__}: the card's differs from the CPU's")
    launches["edt"] = {"edt": 1}
    _sq, passes = edt_sq_passes(masks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    distance_transform_edt(masks)
    torch.cuda.synchronize()
    edt_ms = 1e3 * (time.perf_counter() - t0)
    full, full_passes = edt_sq_passes(torch.ones((1,) + gray.shape[1:], dtype=torch.uint8,
                                                 device=dev))
    if not torch.isinf(full).all():
        raise AssertionError("the EDT of an all-foreground frame is not +inf everywhere")
    out["edt"] = {"card_equal_cpu": True, "passes_cols_rows": list(passes), "ms": edt_ms,
                  "foreground_px": int((masks > 0).sum()),
                  "all_foreground_inf": True, "all_foreground_passes": list(full_passes)}
    reset()
    boundary = mask_boundary(masks)
    k1m = counts()["morph_u8"]
    if k1m != 1 or not torch.equal(boundary.cpu(), mask_boundary(masks_cpu)):
        raise AssertionError(f"mask_boundary: {k1m} K1m launches, or it differs from the CPU's")
    binary = (masks > 0).to(torch.uint8)  # K1m's input in mask_boundary
    se3 = structuring_element("rect", 3)
    check_equal(err, "morph_u8", [("eroded", morph_u8(binary, se3, True), erode(binary, se3))],
                "mask_boundary's input")
    launches["mask_boundary"] = {"morph_u8": k1m}
    out["mask_boundary"] = {"k1m_launches": k1m, "equal_plain_and_cpu": True,
                            "boundary_px": int(boundary.sum())}
    del x, folded, masks, masks_cpu, full, boundary, binary

    # 3. the chain route at full width
    clip_bgr = np.repeat(clip[..., None], 3, axis=-1)

    def route(chain_route):
        video = (tf.FilterMonochrome(VideoMemory(clip_bgr), device=dev) if chain_route
                 else VideoMemory(clip))
        sp = StreamingPipeline(cfg, max_components=MAX_COMPONENTS)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        rows = sp.run(video, background0=plate)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        if hashlib.sha256(format_rows(rows).encode()).hexdigest() != REF_CSV_SHA256:
            raise AssertionError(f"{'chain' if chain_route else 'gray'} route rows differ "
                                 "from the reference's")
        return clip.shape[0] / s, counts()

    _fps, chain_counts = route(True)  # checked and counted; untimed
    nb = -(-clip.shape[0] // cfg.batch)
    if (min(chain_counts["fused_segment"], chain_counts["ccl_labels"],
            chain_counts["root_stats_occ"], chain_counts["track_scan"]) < nb
            or chain_counts["ccl_stats"] or chain_counts["chain_program"] != nb
            or chain_counts["bgr_to_gray"] != nb):
        raise AssertionError(f"chain route launches: {chain_counts}")
    launches["chain_route"] = chain_counts
    route(False)  # the gray route's first run of the phase: untimed
    fps = {"gray": [], "chain": []}
    for which in ("gray", "chain", "chain", "gray"):
        fps[which].append(route(which == "chain")[0])
    out["route_fps"] = fps
    out["route_csv_sha256_equals_reference"] = True
    frames = FILTER_STAGING_BATCHES * cfg.batch
    reps = -(-frames // clip.shape[0])
    sources = {"gray": lambda: VideoMemory(np.concatenate([clip] * reps)[:frames]),
               "chain": lambda: tf.FilterMonochrome(
                   VideoMemory(np.concatenate([clip_bgr] * reps)[:frames]), device=dev)}
    stage_ms = {}
    for which in ("gray", "chain"):
        video = sources[which]()

        def stager_run():
            st = BatchStager(video, cfg.batch, queue_depth=3, device=dev)
            ready = []
            try:
                for _n, _b in st:
                    torch.cuda.current_stream().synchronize()
                    ready.append(time.perf_counter())
            finally:
                st.close()
            return 1e3 * (ready[-1] - ready[0]) / (len(ready) - 1)

        stager_run()  # warm-up
        stage_ms[which] = [stager_run() for _ in range(3)]
        del video
    out["stager_ms_per_batch"] = {k: dict(spread(v), runs=v) for k, v in stage_ms.items()}
    out["staged_bytes_per_batch"] = {"gray": cfg.batch * int(np.prod(clip.shape[1:])),
                                     "chain": cfg.batch * int(np.prod(clip_bgr.shape[1:]))}
    chain = tf.FilterMonochrome(VideoMemory(clip_bgr), device=dev)
    batch = torch.from_numpy(clip_bgr[:cfg.batch]).to(dev)
    out["chain_program_ms"] = cuda_ms(lambda: tf.run_chain(chain, batch, (None,)), 3)
    out["chain_program_bound_ms"] = bound(batch.numel() + batch.numel() // 3,
                                          5 * batch.numel() // 3)[0]
    del batch

    # 4. a stateful chain through iter_batches
    def stateful(data, device):
        return tf.FilterBackground(tf.FilterBlur(tf.FilterMonochrome(
            VideoMemory(data), device=device), 5), 0.02)

    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    got = list(stateful(clip_bgr, dev).iter_batches(cfg.batch))
    s = time.perf_counter() - t0
    n = counts()
    if (n["blur_u8"] != nb or n["fused_segment"] != nb or n["chain_program"] != nb
            or n["bgr_to_gray"] != nb):
        raise AssertionError(f"stateful chain launches: {n}")
    launches["stateful_chain"] = {"blur_u8": n["blur_u8"], "fused_segment": n["fused_segment"],
                                  "chain_program": n["chain_program"],
                                  "bgr_to_gray": n["bgr_to_gray"]}
    ref = np.concatenate([o[:k] for k, o in stateful(clip_bgr[:48], "cpu").iter_batches(48)])
    if not np.array_equal(got[0][1][:48], ref):
        raise AssertionError("the stateful chain's first 48 frames differ from the CPU's")
    out["stateful_chain"] = {"fps": clip.shape[0] / s, "first_48_equal_cpu": True,
                             "ksize": stateful(clip_bgr[:1], "cpu").source.ksize}

    # 5. KM, KW, KR and KE against their plain versions, then timed
    masks, _bg = fused_segment(torch.from_numpy(gray).to(dev),
                               torch.from_numpy(plate.astype(np.float32)).to(dev), **BENCH_KW)
    out["kernel_checks"] = filter_kernel_checks(gray.shape, masks, err)
    out["kernel_checks"]["float"] = float_kernel_checks(gray, err)
    batch = torch.from_numpy(clip_bgr[:cfg.batch]).to(dev)
    timing = filter_kernel_timing(gray.shape, batch, masks)
    timing.update(float_kernel_timing(gray))
    del masks, batch
    kernels = {name: dict(timing[name], launches=launches[key][kernel]) for name, key, kernel in (
        ("bgr_to_gray", "chain_route", "bgr_to_gray"),
        ("warp_affine", "rotate_7.5_gray", "warp_affine"),
        ("resize_linear", "resize_960x540_gray", "resize_linear"), ("edt", "edt", "edt"),
        ("gaussian_blur_f32", "blur_float_gray", "gaussian_blur_f32"),
        ("gaussian_blur_f32_bgr", "blur_float_bgr", "gaussian_blur_f32"),
        ("background_scan_sequential", "background_float_gray", "background_scan_sequential"))}
    # KR's other timed shapes (FilterResize's launches on them)
    kernels.update({name: dict(timing[name], launches=launches[key]["resize_linear"])
                    for name, key in (("resize_linear_gray", "resize_960x540_gray"),
                                      ("resize_linear_x1.5", "resize_x1.5_bgr"))})
    out["seconds"] = round(time.time() - t_phase, 1)
    return out, launches, kernels


# the kernel each filter of filter_cases launches once a batch on the card
FILTER_KERNELS = {"blur_u8": "blur_u8", "background": "fused_segment", "median_3": "median_u8",
                  "blur_float": "gaussian_blur_f32",
                  "background_float": "background_scan_sequential",
                  "median_5": "median_u8", "monochrome": "bgr_to_gray",
                  "resize_960x540": "resize_linear", "resize_x1.5": "resize_linear",
                  "rotate_7.5": "warp_affine", "warp_affine": "warp_affine"}
# KW's and KR's cases of phase 7e at 1080p: FilterRotate(angle=7.5)'s map
# (rotation_matrix((959.5, 539.5), 7.5)), filter_cases' warp with its
# out_size and border value, the replicate border, an inverse map
WARP_M = [[0.96, 0.12, -40.0], [-0.1, 1.04, 25.5]]
KR_SIZES_1080 = ((960, 540), (2880, 1620), (1920, 540))


def kw_cases_1080():
    from tpuva_torch.ops.warp import rotation_matrix

    return {"rotate_7.5": dict(M=rotation_matrix((959.5, 539.5), 7.5)),
            "warp_out_size_border7": dict(M=WARP_M, out_size=(1600, 900), border_value=7.0),
            "replicate": dict(M=WARP_M, border="replicate"),
            "inverse": dict(M=WARP_M, inverse=True)}


def finite(t):
    """t with +inf as -1 (a value no distance takes): check_equal's
    difference stays finite, equality is unchanged."""
    return torch.nan_to_num(t, posinf=-1.0)


def filter_kernel_checks(shape, masks, err):
    """KM, KW, KR and KE against their plain versions on the card, bit for
    bit, on random frames of shape (N, H, W) and BGR (three independent
    channels: equal ones would hide a wrong weight order) and on K1's masks
    of the phase's frames; KW on a map of each of its routes (every tile
    staged, some tiles gathering); KE also on scenes.edt_large_scenes (sums
    past 2^24, 8K UHD, a row wider than shared memory, 65,536 masks in two
    launches), its passes equal the loop's; the max abs differences folded
    into err."""
    from tpuva_torch.ops import color, resize, warp
    from tpuva_torch.ops.distance import (
        distance_transform_edt, edt_kernel, edt_sq_passes, edt_sq_passes_plain,
    )
    from tpuva_torch.scenes import edt_large_scenes

    dev = torch.device("cuda")
    rng = np.random.default_rng(40)
    gray = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    bgr = torch.from_numpy(rng.integers(0, 256, tuple(shape) + (3,), dtype=np.uint8)).to(dev)
    unaligned = bgr.reshape(-1)[3:].reshape(-1, 3)[:-1]  # 3 bytes in: the pixel path
    bgr_f = bgr.to(torch.float32)
    check_equal(err, "bgr_to_gray", [
        ("uint8", color.bgr_to_gray(bgr), color.bgr_to_gray_plain(bgr)),
        ("float32", color.bgr_to_gray(bgr_f), color.bgr_to_gray_plain(bgr_f)),
        ("unaligned", color.bgr_to_gray(unaligned), color.bgr_to_gray_plain(unaligned))],
        "random 1080p BGR")
    del bgr_f
    for what, frames in (("gray", gray), ("bgr", bgr)):
        for case, kw in kw_cases_1080().items():
            check_equal(err, "warp_affine", [(f"{case} {what}", warp.warp_affine(frames, **kw),
                                              warp.warp_affine_plain(frames, **kw))],
                        "random 1080p frames")
        for size in KR_SIZES_1080:
            check_equal(err, "resize_linear", [
                (f"{size} {what}", resize.resize_linear(frames, size),
                 resize.resize_linear_plain(frames, size))], "random 1080p frames")
    # KW's two routes at 1080p: FilterRotate's map stages every tile's
    # footprint, a 4x down-scale gathers from global memory
    routes = {}
    for case, kw in (("rotate_7.5", kw_cases_1080()["rotate_7.5"]),
                     ("down_4x", dict(M=[[0.25, 0.0, 3.0], [0.0, 0.25, 1.0]], out_size=(480, 270),
                                      border_value=5.0))):
        got, r = warp.warp_affine_routes(bgr, **kw)
        ref = warp.warp_affine_plain(bgr, **kw)
        check_equal(err, "warp_affine", [(f"{case} routes", got, ref)], "random 1080p BGR")
        routes[case] = list(r)
    if routes["rotate_7.5"][1] != 0 or routes["down_4x"][1] == 0:
        raise AssertionError(f"KW's routes (shared, direct tiles): {routes}")
    # KR's two routes: every tile staged to 960 x 540 (also from an input
    # one byte into its buffer: byte copies), tiles gathering to 61 wide
    kr_routes = {}
    shifted = torch.empty(bgr.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    shifted = shifted.view(bgr.shape).copy_(bgr)
    for case, frames, size in (("960x540", bgr, (960, 540)), ("offset_1", shifted, (960, 540)),
                               ("61x540", bgr, (61, 540))):
        got, r = resize.resize_linear_routes(frames, size)
        check_equal(err, "resize_linear", [(f"{case} routes", got,
                                            resize.resize_linear_plain(frames, size))],
                    "random 1080p BGR")
        vec = frames.data_ptr() % 16 == 0
        plan = resize.resize_plan(frames.shape[0], *frames.shape[1:3], 3, size, vec)
        if list(r) != [int(plan.staged.sum()), int((~plan.staged).sum())]:
            raise AssertionError(f"KR's routes {case}: {r}, the plan's {plan.staged.sum()}")
        kr_routes[case] = list(r)
    del shifted
    if kr_routes["960x540"][1] or kr_routes["offset_1"][1] or not kr_routes["61x540"][1]:
        raise AssertionError(f"KR's routes (staged, gathered tiles): {kr_routes}")
    passes = {}
    _N, H, W = shape
    cases = [("K1's masks", masks),
             ("all foreground", torch.ones((1, H, W), dtype=torch.uint8, device=dev)),
             ("all background", torch.zeros((1, H, W), dtype=torch.uint8, device=dev))]
    cases += [(name, torch.from_numpy(m).to(dev)) for name, m in edt_large_scenes().items()]
    for what, m in cases:
        before = edt_kernel.launches
        sq, p = edt_sq_passes(m)
        n_launch = edt_kernel.launches - before
        ref, ref_p = edt_sq_passes_plain(m)
        check_equal(err, "edt", [("squared", finite(sq), finite(ref)),
                                 ("distance", finite(distance_transform_edt(m)),
                                  finite(torch.sqrt(ref)))], what)
        if p != ref_p:
            raise AssertionError(f"KE's passes {p} differ from the plain loop's {ref_p} ({what})")
        passes[what] = list(p) + [n_launch]
    if passes["masks_65536x5x7"][2] != 2:
        raise AssertionError("KE did not split 65,536 masks over two launches")
    return {"bit_equal": ["bgr_to_gray", "warp_affine", "resize_linear", "edt"],
            "kw_cases": sorted(kw_cases_1080()), "kr_sizes": [list(v) for v in KR_SIZES_1080],
            "kw_routes_shared_direct": routes, "kr_routes_staged_gathered": kr_routes,
            "edt_passes_cols_rows_launches": passes}


def filter_kernel_timing(shape, batch, masks, reps=5):
    """Each of KM, KW, KR, KE: {ms, plain_ms, library_ms, bound_ms, bound_by}
    (CUDA events, after a warm-up): KM on the chain route's staged BGR
    batch (library: torch.matmul of its float32 copy with the weights); KW
    (FilterRotate(angle=7.5)'s map, constant border) and KR (to 960 x 540)
    on random BGR frames of shape (library: F.grid_sample and F.interpolate,
    bilinear, on float32 copies, channels first); KE on K1's masks (no
    library call computes an EDT)."""
    from tpuva_torch.ops import color, resize, warp
    from tpuva_torch.ops.distance import distance_transform_edt, edt_sq_passes_plain

    F = torch.nn.functional
    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    bgr = torch.from_numpy(rng.integers(0, 256, tuple(shape) + (3,), dtype=np.uint8)).to(dev)
    res = {}

    def entry(fn, plain, library, nbytes, nops, frames):
        b = bound(nbytes, nops)
        return {"ms": cuda_ms(fn, reps), "plain_ms": cuda_ms(plain, 2),
                "library_ms": None if library is None else cuda_ms(library, reps),
                "bound_ms": b[0], "bound_by": b[1], "shape": list(frames.shape)}

    # KM: 3 B read and 1 B written, 3 products and 2 sums a pixel
    P = batch.numel() // 3
    xf = batch.to(torch.float32)
    w = torch.from_numpy(color.BGR_WEIGHTS).to(dev)
    res["bgr_to_gray"] = entry(lambda: color.bgr_to_gray(batch),
                               lambda: color.bgr_to_gray_plain(batch),
                               lambda: torch.matmul(xf, w), 4 * P, 5 * P, batch)
    del xf
    # KW: the frames read and the output written once; 6 operations a
    # pixel for the coordinates, 9 a channel for the lerps
    kw = kw_cases_1080()["rotate_7.5"]
    plan = warp.warp_plan(bgr.shape, kw["M"])
    ia, ib, ic, id_, ie, if_ = plan.coeffs
    xs = torch.arange(plan.wo, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(plan.ho, dtype=torch.float32, device=dev)[:, None]
    sx, sy = ia * xs + ib * ys + ic, id_ * xs + ie * ys + if_
    grid = torch.stack([(2 * sx + 1) / plan.W - 1, (2 * sy + 1) / plan.H - 1], dim=-1)
    grid = grid.expand(plan.L, -1, -1, -1).contiguous()
    xf = bgr.permute(0, 3, 1, 2).to(torch.float32)
    out_px = plan.L * plan.ho * plan.wo
    res["warp_affine"] = entry(
        lambda: warp.warp_affine(bgr, **kw), lambda: warp.warp_affine_plain(bgr, **kw),
        lambda: F.grid_sample(xf, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False),
        bgr.numel() + 3 * out_px, out_px * (6 + 9 * 3), bgr)
    del grid
    # KR: the frames read and the output written once; 3 operations a tap
    # pass and channel (both axes resampled): BGR to 960 x 540 (the kernels
    # line's), gray to 960 x 540 and BGR up to 2880 x 1620
    gray = bgr[..., 0].contiguous()
    for name, frames, ff, size in (
            ("resize_linear", bgr, xf, KR_SIZES_1080[0]),
            ("resize_linear_gray", gray, gray[:, None].to(torch.float32), KR_SIZES_1080[0]),
            ("resize_linear_x1.5", bgr, xf, KR_SIZES_1080[1])):
        C = frames.shape[3] if frames.dim() == 4 else 1
        out_px = frames.shape[0] * size[0] * size[1]
        res[name] = entry(
            lambda f=frames, s=size: resize.resize_linear(f, s),
            lambda f=frames, s=size: resize.resize_linear_plain(f, s),
            lambda f=ff, s=size: F.interpolate(f, size=(s[1], s[0]), mode="bilinear",
                                               align_corners=False, antialias=False),
            frames.numel() + C * out_px, out_px * C * 9, frames)
    del xf, gray
    # KE: the masks read and the float32 distances written once
    px = masks.numel()
    res["edt"] = entry(lambda: distance_transform_edt(masks),
                       lambda: torch.sqrt(edt_sq_passes_plain(masks)[0]), None, 5 * px, 0, masks)
    return res


# KG's cases of phase 7e at 1080p: the cascade (3, 5; non-integer input),
# cv2's sigma <= 0 table (7), FilterBlur's sigma 1.5 case (9), a wide one
KG_CASES = ((3, 0.0), (5, 0.0), (7, 0.0), (9, 1.5), (31, 0.0))
# edge shapes: one column; H below the radius (31 taps on 5 rows, gray and
# BGR); a window no tile holds (the direct route)
KG_EDGE_CASES = (((4, 120, 1), 9, False), ((4, 120, 1), 31, False), ((3, 5, 40), 31, False),
                 ((2, 5, 40, 3), 31, True), ((2, 9, 7, 3), 121, True))


def normalized(frames):
    """FilterNormalize's float32 output of uint8 frames on the card: (x -
    0) times float32(1/255), clipped; none of its values is an integer but
    0 and 1."""
    from tpuva_torch import filters as tf
    from tpuva_torch.io.memory import VideoMemory

    x = torch.from_numpy(frames).to("cuda")
    return tf.FilterNormalize(VideoMemory(frames[:1]), device="cuda").batch_transform(x, None)


def float_kernel_checks(gray, err):
    """KG (gaussian_blur) and KS's sequential order against their plain
    versions on the card, bit for bit: KG at KG_CASES on FilterNormalize's
    output of the phase's gray frames and of random BGR frames (16 at
    1080p, the channels interleaved), and on KG_EDGE_CASES; KS's
    sequential order on the normalized gray frames (check_ks_sequential).
    The max abs differences folded into err."""
    from tpuva_torch.ops.filters import blur_float_plan, gaussian_blur, gaussian_blur_plain

    rng = np.random.default_rng(42)
    x = normalized(gray)
    xb = normalized(rng.integers(0, 256, gray.shape + (3,), dtype=np.uint8))
    plans = {}
    for ksize, sigma in KG_CASES:
        for what, frames, cl in (("gray", x, False), ("bgr", xb, True)):
            check_equal(err, "gaussian_blur_f32", [
                (f"k {ksize} sigma {sigma} {what}", gaussian_blur(frames, ksize, sigma, cl),
                 gaussian_blur_plain(frames, ksize, sigma, cl))], "normalized 1080p frames")
            plans[f"{ksize}_{what}"] = list(blur_float_plan(3 if cl else 1, ksize))
    for shape, ksize, cl in KG_EDGE_CASES:
        frames = torch.from_numpy(rng.random(shape, dtype=np.float32)).to("cuda")
        check_equal(err, "gaussian_blur_f32", [
            (f"{list(shape)} k {ksize}", gaussian_blur(frames, ksize, 0.0, cl),
             gaussian_blur_plain(frames, ksize, 0.0, cl))], "edge shapes")
        plans[f"{ksize}_{'x'.join(map(str, shape))}"] = list(
            blur_float_plan(3 if cl else 1, ksize))
    del xb
    check_ks_sequential(err, x, "FilterNormalize's 1080p frames")
    return {"kg_bit_equal": [list(c) for c in KG_CASES],
            "kg_edge_cases": [[list(s), k] for s, k, _c in KG_EDGE_CASES],
            "kg_plans_th_tw_smem": plans, "ks_sequential_bit_equal": True}


def float_kernel_timing(gray, reps=5):
    """KG at FilterBlur's k = 9, sigma 1.5 on FilterNormalize's output of
    the gray frames and of their BGR (three equal channels, interleaved);
    KS's sequential order on the normalized gray frames from a random
    background (FilterBackground's float batch). Each {ms, plain_ms,
    library_ms, bound_ms, bound_by}, CUDA events after a warm-up; KG's
    library time is two calls, F.conv2d with the row taps and then the
    column taps, each over an F.pad(mode="reflect") (REFLECT_101), float32
    with cuDNN's TF32 off; KS has none."""
    from tpuva_torch.ops.background import background_scan, background_scan_plain
    from tpuva_torch.ops.filters import gaussian_blur, gaussian_blur_plain, gaussian_kernel_1d

    F = torch.nn.functional
    x = normalized(gray)
    xb = x[..., None].expand(-1, -1, -1, 3).contiguous()
    ksize, sigma = 9, 1.5
    r = ksize // 2
    k = torch.from_numpy(gaussian_kernel_1d(ksize, sigma)).to("cuda")
    res = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, frames, cl in (("gaussian_blur_f32", x, False),
                                 ("gaussian_blur_f32_bgr", xb, True)):
            planes = (frames.permute(0, 3, 1, 2) if cl else frames[:, None]).reshape(
                -1, 1, *frames.shape[1:3]).contiguous()

            def library(p=planes):
                y = F.conv2d(F.pad(p, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
                return F.conv2d(F.pad(y, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))

            b = bound(8 * frames.numel(), 2 * (3 * r + 1) * frames.numel())
            res[name] = {"ms": cuda_ms(lambda f=frames, c=cl: gaussian_blur(f, ksize, sigma, c),
                                       reps),
                         "plain_ms": cuda_ms(lambda f=frames, c=cl: gaussian_blur_plain(
                             f, ksize, sigma, c), 2),
                         "library_ms": cuda_ms(library, reps),
                         "library": "2 calls: F.conv2d over F.pad(reflect), row then column",
                         "bound_ms": b[0], "bound_by": b[1], "shape": list(frames.shape),
                         "ksize": ksize, "sigma": sigma}
            del planes
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    bg0 = torch.rand(x.shape[1:], device="cuda")
    N, P = x.shape[0], x[0].numel()
    b = bound(5 * N * P + 8 * P, 6 * N * P)
    res["background_scan_sequential"] = {
        "ms": cuda_ms(lambda: background_scan(x, bg0, 0.02, False, "sequential", "diff"), reps),
        "plain_ms": cuda_ms(lambda: background_scan_plain(x, bg0, 0.02, False, "sequential",
                                                          "diff"), 2),
        "library_ms": None, "bound_ms": b[0], "bound_by": b[1], "shape": list(x.shape)}
    return res


# Phase 7j: KS's checks at the route's shapes and edge shapes
KS_N = (1, 2, 3, 7, 255, 256, 257)
# ragged frames, one column, and N past a CTA's 224 pixels: 32 pixels a
# CTA at 1024, the global scratch at 2000 (ops/background.py::scan_plan)
KS_EDGE_SHAPES = ((5, 250, 333), (4, 120, 1), (1024, 24, 32), (2000, 12, 16))


def ks_ops_per_px(N, ops):
    """Least float32 operations a pixel of KS's scanned order: o_t = a F_t
    (N), two a combine (ops of them), B_t = S_t B_0 + O_t (2N), the emit's
    difference, abs and compare or rounding (3N)."""
    return 6 * N + 2 * ops


def ks_scan_bound(N, P):
    """(least ms, what bounds it, shared-memory ms) of KS's scan on N
    uint8 frames of P pixels: the frames read and the emit written once,
    the background read and written once; the operations at 67 T/s; and
    beside them the shared memory it moves (each o value written once and
    read once for B, three accesses a combine) at 128 B a clock an SM."""
    from tpuva_torch.ops.background import scan_tables

    ops = scan_tables(N, 0.02).size - N
    b = bound(2 * N * P + 8 * P, ks_ops_per_px(N, ops) * P)
    smem = 4 * (2 * N + 3 * ops) * P / (128 * SMS * SM_CLOCK_HZ) * 1e3
    return b[0], b[1], smem


def check_ks_sequential(err, frames, where):
    """KS's sequential order against its plain version on float frames,
    unseeded from a random background and seeded by a flag on the card,
    both emits, bit for bit."""
    from tpuva_torch.ops.background import background_scan, background_scan_plain

    dev = frames.device
    bg0 = torch.rand(frames.shape[1:], device=dev)
    seed = torch.ones((), dtype=torch.bool, device=dev)
    for seed_bg in (False, seed):
        for emit, thr in (("diff", None), ("mask", 0.05)):
            got = background_scan(frames, bg0, 0.02, seed_bg, "sequential", emit, thr)
            ref = background_scan_plain(frames, bg0, 0.02, seed_bg, "sequential", emit, thr)
            check_equal(err, "background_scan_sequential", zip(("out", "bg_last"), got, ref),
                        f"{where}, {emit}, seeded {seed_bg is not False}")


def scanned_phase(clip, plate, card, cfg, err, counters):
    """Phase 7j, the scanned background (parallel_bg) on the card.

    1. KS (ops.background.background_scan, order "scan") against its plain
       version on the card, bit for bit, the emit and the post-batch
       background: the bench clip's two 256-frame batches after the filter
       prefix (K1b), from the plate and seeded, then the second carried
       from the first, both emits; N in KS_N on (N, 120, 160) random bytes
       (seeded by a flag on the card at odd N); KS_EDGE_SHAPES; KS's
       sequential order on float frames out of FilterNormalize.
    2. The scanned route over the clip: process_clip(parallel_bg=True) and
       StreamingPipeline(parallel_bg=True) over VideoMemory, each run's
       CSV sha256 equal to REF_SCANNED_CSV_SHA256, KS, K1b, K3, K6 and K5
       once a batch, K1m its morph_plan groups a batch, K1 never; the same
       process_clip with background_scan_plain in KS's place on the card
       (the torch ops the route ran before KS) at the same pin; the rows
       that differ from the sequential route's (REF_CSV_SHA256); peak
       device memory of each; frames/s of each after its checked run, and
       of the sequential route, in turns.
    3. The front end (_front_end_emit with parallel_bg) on one 256-frame
       batch on KS and on the plain version (CUDA events), and KS alone
       beside its plain version and its bound.
    Returns (the phase line's fields, KS's entry of the kernels line)."""
    import tpuva_torch.graph.pipeline as tpp
    from tpuva_torch.export.csvio import format_rows
    from tpuva_torch.graph.pipeline import process_clip
    from tpuva_torch.graph.streaming import StreamingPipeline
    from tpuva_torch.io.memory import VideoMemory
    from tpuva_torch.ops.background import background_scan, background_scan_plain, scan_plan
    from tpuva_torch.ops.wide import morph_plan, open_close_steps

    dev = torch.device("cuda")
    t_phase = time.time()
    out = {"card": card}
    H, W = clip.shape[1:]
    N = cfg.batch
    alpha, thr = cfg.background.alpha, cfg.segment.threshold

    def ks_pair(frames, bg0, seed_bg, emit, where):
        th = thr if emit == "mask" else None
        got = background_scan(frames, bg0, alpha, seed_bg, "scan", emit, th)
        ref = background_scan_plain(frames, bg0, alpha, seed_bg, "scan", emit, th)
        check_equal(err, "background_scan", zip(("out", "bg_last"), got, ref), where)
        return got

    # 1. KS against its plain version
    plate_t = torch.from_numpy(plate.astype(np.float32)).to(dev)
    f1 = tpp._filter_u8(cfg, torch.from_numpy(clip[:N]).to(dev))
    f2 = tpp._filter_u8(cfg, torch.from_numpy(clip[N:2 * N]).to(dev))
    n_cmp = 0
    for emit in ("mask", "diff"):
        ks_pair(f1, plate_t, False, emit, f"clip batch 1 from the plate, {emit}")
        _o, carried = ks_pair(f1, plate_t, True, emit, f"clip batch 1 seeded, {emit}")
        ks_pair(f2, carried, False, emit, f"clip batch 2 carried, {emit}")
        n_cmp += 3
    del f2, carried
    rng = np.random.default_rng(26)
    seed = torch.ones((), dtype=torch.bool, device=dev)
    shapes = [(n, 120, 160) for n in KS_N] + list(KS_EDGE_SHAPES)
    for shape in shapes:
        frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        bg0 = torch.from_numpy(rng.uniform(0, 255, shape[1:]).astype(np.float32)).to(dev)
        for emit in ("mask", "diff"):
            for seed_bg in (False, seed if shape[0] % 2 else True):
                ks_pair(frames, bg0, seed_bg, emit, f"random {list(shape)}, {emit}")
                n_cmp += 1
    check_ks_sequential(err, normalized(clip[:FILTER_FRAMES]), "FilterNormalize's 1080p frames")
    out["ks_vs_plain"] = {"comparisons": n_cmp, "bit_equal": True, "N": list(KS_N),
                          "edge_shapes": [list(s) for s in KS_EDGE_SHAPES],
                          "plan_256": scan_plan(N, H * W)._asdict(),
                          "plan_1024": scan_plan(1024, H * W)._asdict(),
                          "plan_2048": scan_plan(2048, H * W)._asdict(),
                          "sequential_bit_equal": True}

    # 2. the scanned route
    nb = -(-clip.shape[0] // N)
    groups = len(morph_plan(H, W, open_close_steps(tpp._morph_stages(cfg))))
    names = ("background_scan", "background_scan_sequential", "blur_u8", "morph_u8",
             "fused_segment", "ccl_labels", "root_stats_occ", "track_scan")

    def run(route, parallel_bg=True):
        """One run of the clip on cuda: (rows, seconds, launches, peak GiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for name in names:
            fn, attr = counters[name]
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        if route == "stream":
            rows = StreamingPipeline(cfg, max_components=MAX_COMPONENTS,
                                     parallel_bg=parallel_bg).run(VideoMemory(clip),
                                                                  background0=plate)
        else:
            rows = process_clip(clip, cfg, background0=plate, max_components=MAX_COMPONENTS,
                                parallel_bg=parallel_bg, device="cuda")[0]
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        counts = {name: getattr(*counters[name]) for name in names}
        return rows, s, counts, torch.cuda.max_memory_allocated() / 2**30

    def held(route, rows, ref):
        data = format_rows(rows).encode()
        if hashlib.sha256(data).hexdigest() != ref:
            with open(os.path.join(OUT_DIR, f"tracks_512_scanned_{route}.csv"), "wb") as fh:
                fh.write(data)
            raise AssertionError(f"scanned route {route}: rows differ from the pin")

    seq_rows, _s, _c, _p = run("process_clip", parallel_bg=False)
    held("sequential", seq_rows, REF_CSV_SHA256)
    routes = {}
    for route in ("process_clip", "stream", "process_clip_plain"):
        plain = route.endswith("_plain")
        if plain:  # the route with the torch ops KS replaced, on the card
            tpp.background_scan = background_scan_plain
        try:
            rows, s, counts, peak = run(route.replace("_plain", ""))
        finally:
            tpp.background_scan = background_scan
        held(route, rows, REF_SCANNED_CSV_SHA256)
        want = dict(background_scan=0 if plain else nb, background_scan_sequential=0,
                    blur_u8=nb, morph_u8=nb * groups, fused_segment=0, ccl_labels=nb,
                    root_stats_occ=nb, track_scan=nb)
        if counts != want:
            raise AssertionError(f"scanned route {route} launches {counts}, want {want}")
        only_scan = len(set(map(tuple, rows)) - set(map(tuple, seq_rows)))
        only_seq = len(set(map(tuple, seq_rows)) - set(map(tuple, rows)))
        routes[route] = dict(rows=len(rows), track_ids=len({int(r[0]) for r in rows}),
                             rows_not_in_sequential=only_scan,
                             sequential_rows_not_here=only_seq,
                             launches=counts,
                             peak_device_gib=peak, checked_run_seconds=s)
    # frames/s after the checked runs, in turns with the sequential route
    fps = {"process_clip": [], "stream": [], "sequential": []}
    for which in ("process_clip", "sequential", "stream", "stream", "sequential", "process_clip"):
        _r, s, _c, _p = run("process_clip" if which == "sequential" else which,
                            parallel_bg=which != "sequential")
        fps[which].append(clip.shape[0] / s)
    out["batches"] = nb
    out["routes"] = routes
    out["fps"] = fps
    out["csv_sha256_equals_pin"] = True

    # 3. the front end on one batch, and KS alone, on the card
    frames = torch.from_numpy(clip[:N]).to(dev)
    carry = tpp.init_carry(cfg, H, W, plate, device=dev)

    def front_end_plain():
        tpp.background_scan = background_scan_plain
        try:
            return tpp._front_end_emit(cfg, carry, frames, True)
        finally:
            tpp.background_scan = background_scan

    out["front_end_ms"] = cuda_ms(lambda: tpp._front_end_emit(cfg, carry, frames, True), 5)
    out["front_end_plain_ms"] = cuda_ms(front_end_plain, 3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tpp._front_end_emit(cfg, carry, frames, True)
    out["front_end_peak_extra_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.reset_peak_memory_stats()
    front_end_plain()
    out["front_end_plain_peak_extra_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    b_ms, b_by, smem_ms = ks_scan_bound(N, H * W)
    kernel = {"ms": cuda_ms(lambda: background_scan(f1, plate_t, alpha, False, "scan", "mask",
                                                    thr), 5),
              "plain_ms": cuda_ms(lambda: background_scan_plain(f1, plate_t, alpha, False,
                                                                "scan", "mask", thr), 3),
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
              "smem_bound_ms": smem_ms,
              "launches": routes["process_clip"]["launches"]["background_scan"]}
    out["ks"] = kernel
    del f1, frames
    out["seconds"] = round(time.time() - t_phase, 1)
    return out, kernel


def main():
    modes = ("--k1", "--k2", "--k5", "--wide", "--median", "--probes", "--staging",
             "--multistream", "--filters", "--spatial", "--configs", "--soak", "--scanned")
    mode = sys.argv[1] if len(sys.argv) == 2 and sys.argv[1] in modes else None
    if sys.argv[1:] and mode is None:
        print(f"usage: chip_smoke.py [{' | '.join(modes)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    clip_pool = clip_futures = None
    if mode in (None, "--configs"):  # phase 7h's clips, made while the card works
        clip_pool, clip_futures = start_baseline_clips()
    try:
        return run_phases(mode, clip_futures)
    finally:
        if clip_pool is not None:
            clip_pool.shutdown(wait=True, cancel_futures=True)


def run_phases(mode, clip_futures):
    k1_only = mode == "--k1"
    from refimpl.synthetic import multi_blob_clip
    from tpuva_torch import _build
    from tpuva_torch.export.csvio import format_rows, write_tracks_csv
    from tpuva_torch.graph import config
    from tpuva_torch.graph.pipeline import (
        _diff_kwargs, _finish_batch, _front_end_kwargs, _morph_stages, filter_batch, init_carry,
        process_batch, process_batch_staged, process_clip,
    )
    from tpuva_torch.graph.streaming import StreamingPipeline
    from tpuva_torch.io.memory import VideoMemory
    from tpuva_torch.io.staging import BatchStager
    from tpuva_torch.ops import connected_components_with_stats
    from tpuva_torch.ops.ccl import label_components_tiled, label_stats, label_sums_plain
    from tpuva_torch.ops.filters import (
        _morph, blur_taps, gaussian_blur_u8, histogram_u8, histogram_u8_plain, morph_steps_plain,
        otsu_threshold, structuring_element,
    )
    from tpuva_torch.ops.fused_segment import fused_segment, fused_segment_plain, k1_split
    from tpuva_torch.ops.wide import blur_u8, morph_u8
    from tpuva_torch.ops.median import median_u8
    from tpuva_torch.ops.label import _assemble_stats, extract_detections, label_components
    from tpuva_torch.scenes import (
        DET_KINDS, K1_REFUSED, det_sequence, k1_refused_config, mixed_scene, u_shape,
    )
    from tpuva_torch.track.scan import track_scan, track_scan_plain
    from tpuva_torch.track.table import init_track_state

    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")
    t_all = time.time()

    # 1. card
    card = card_line()
    print(card, flush=True)
    say("card", torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # 2. build
    t0 = time.time()
    lib_path, log = _build.build(verbose=True)
    _build.load()
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as fh:
        fh.write(log)
    say("build", seconds=round(time.time() - t0, 2), library=str(lib_path.name),
        ptxas=ptxas_summary(log), probes_ptxas=ptxas_summary(log, probes=True))
    if mode == "--probes":
        probes_phase(card)
        return 0
    if mode == "--median":
        return median_mode(card, lib_path)
    if mode == "--staging":
        clip, _alive, _truth, plate = multi_blob_clip(1080, 1920, 512, n_blobs=6, radius=16,
                                                      births_deaths=False, noise_sigma=2.0)
        say("staging", **staging_timing(clip, plate, card, bench_cfg(config, 256)))
        return 0
    if mode in ("--k2", "--k5", "--wide"):
        clip, _alive, _truth, plate = multi_blob_clip(1080, 1920, 256, n_blobs=6, radius=16,
                                                      births_deaths=False, noise_sigma=2.0)
        return {"--k2": k2_timing, "--k5": k5_timing, "--wide": wide_timing}[mode](
            clip, plate, card)
    # after --k2, --k5 and --wide: a copy of this file in an earlier
    # checkout times K2, K3, the dense stats, K5, K1m and K1b with the
    # names that checkout has
    # the host library (csrc/batcher.cpp, the staging ring) with the host
    # compiler; a failed build fails the smoke
    t0 = time.time()
    host_lib = _build.build_host()
    _build.load_host()
    say("build_host", seconds=round(time.time() - t0, 2), library=host_lib.name,
        compiler=_build.cxx())
    from tpuva_torch.ops.background import background_scan
    from tpuva_torch.ops.ccl import root_stats
    counters = {"fused_segment": (fused_segment, "launches"),
                "fused_segment_padded_occ": (fused_segment, "padded_launches"),
                "ccl_stats": (label_stats, "launches"),
                "ccl_stats_occ": (label_stats, "occ_launches"),
                "ccl_labels": (label_components_tiled, "launches"),
                "ccl_labels_conn4": (label_components_tiled, "conn4_launches"),
                "root_stats": (root_stats, "launches"),
                "root_stats_occ": (root_stats, "occ_launches"),
                "histogram_u8": (histogram_u8, "launches"),
                "track_scan": (track_scan, "launches"), "blur_u8": (blur_u8, "launches"),
                "morph_u8": (morph_u8, "launches"), "median_u8": (median_u8, "launches"),
                "background_scan": (background_scan, "launches"),
                "background_scan_sequential": (background_scan, "sequential_launches")}
    if mode == "--configs":
        say("configs", cases=configs_phase(clip_futures, counters), card=card)
        return 0
    if mode == "--soak":
        say("soak", card=card, **soak_phase(counters))
        return 0
    if mode == "--multistream":
        clip, _alive, _truth, plate = multi_blob_clip(1080, 1920, 512, n_blobs=6, radius=16,
                                                      births_deaths=False, noise_sigma=2.0)
        err = {"fused_segment_streams": 0.0, "track_scan_streams": 0.0}
        say("multistream", **multistream_phase(clip, plate, card, bench_cfg(config, 256), err)[0])
        return 0
    if mode == "--spatial":
        clip, _alive, _truth, plate = multi_blob_clip(1080, 1920, 512, n_blobs=6, radius=16,
                                                      births_deaths=False, noise_sigma=2.0)
        err = {"fused_segment": 0.0, "fused_segment_diff": 0.0, "histogram_u8": 0.0,
               **{name: 0.0 for name in KB_KERNELS}}
        line, kb_kernels = spatial_phase(clip, plate, card, bench_cfg(config, 256), err)
        say("spatial", **line, max_abs_err=err)
        say("kb_kernels", card=card, **kb_kernels)
        return 0
    if mode == "--scanned":
        clip, _alive, _truth, plate = multi_blob_clip(1080, 1920, 512, n_blobs=6, radius=16,
                                                      births_deaths=False, noise_sigma=2.0)
        err = {"background_scan": 0.0, "background_scan_sequential": 0.0}
        line, _kernel = scanned_phase(clip, plate, card, bench_cfg(config, 256), err, counters)
        say("scanned", **line, max_abs_err=err)
        return 0
    if mode == "--filters":
        clip, _alive, _truth, plate = multi_blob_clip(1080, 1920, 512, n_blobs=6, radius=16,
                                                      births_deaths=False, noise_sigma=2.0)
        err = {"blur_u8": 0.0, "fused_segment_diff": 0.0, "morph_u8": 0.0, "bgr_to_gray": 0.0,
               "warp_affine": 0.0, "resize_linear": 0.0, "edt": 0.0, "gaussian_blur_f32": 0.0,
               "background_scan_sequential": 0.0}
        line, launches, kernels = filters_phase(clip, plate, card, bench_cfg(config, 256), err)
        say("filters", **line, max_abs_err=err)
        say("filters_launches", **launches)
        say("filter_kernels", card=card, **kernels)
        return 0
    from tpuva_torch.ops.ccl import (
        k2_grid, root_labels, root_occupancy_plain, root_stats, root_stats_dict,
    )
    from tpuva_torch.track.scan import scan_plan
    from tpuva_torch.ops.wide import (
        blur_plan, morph_plan, morph_steps, open_close_steps, open_close_u8,
    )
    from tpuva_torch.ops.label import (
        _stats_dict, _stats_from_root, _stats_from_root_plain, root_stats_plain,
    )
    from tpuva_torch.scenes import ROOT_STATS_OPTIONS, conn4_scene, edge_strip_scene
    from tpuva_torch.io.base import VideoBase
    from tpuva_torch.io.parallel_decode import ParallelVideoReader

    # the slice's clip, made once (its first frames also feed phases 3-5)
    t0 = time.time()
    clip, _alive, truth, plate = multi_blob_clip(
        1080, 1920, 256 if k1_only else 512, n_blobs=6, radius=16, births_deaths=False,
        noise_sigma=2.0)
    say("clip", seconds=round(time.time() - t0, 2), shape=list(clip.shape))
    err = {name: 0.0 for name in REPLACES}

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    # 3. K1 against its plain version, bit for bit
    rng = np.random.default_rng(0)
    ragged = rng.integers(0, 256, (5, 250, 333), dtype=np.uint8)
    ragged[:, 100:140, 50:120] = 230
    one_col = rng.integers(0, 256, (4, 120, 1), dtype=np.uint8)
    one_col[:, 40:70] = 240
    cases = [(clip[:16], plate.astype(np.float32)),
             (ragged, rng.uniform(0, 255, (250, 333)).astype(np.float32)),
             (one_col, rng.uniform(0, 255, (120, 1)).astype(np.float32))]
    k1_masks = None
    n_cmp = 0
    for name, kw in K1_CONFIGS.items():
        for frames, bg0 in cases:
            for seed_bg in ((False, True) if name == "bench" else (False,)):
                f_gpu = torch.from_numpy(frames).to(dev)
                b_gpu = torch.from_numpy(bg0).to(dev)
                got = fused_segment(f_gpu, b_gpu, seed_bg=seed_bg, **kw)
                ref = fused_segment_plain(f_gpu, b_gpu, seed_bg=seed_bg, **kw)
                check_equal(err, "fused_segment", zip(("masks", "bg"), got, ref),
                            f"{name}, {tuple(frames.shape)}, seed_bg={seed_bg}")
                n_cmp += 1
                if name == "bench" and frames.shape[0] == 16 and not seed_bg:
                    k1_masks = got[0]
    say("k1_vs_plain", comparisons=n_cmp, bit_equal=True,
        foreground_px=int((k1_masks > 0).sum()))

    # 3b. K1's diff emit and K4 against their plain versions, bit for bit
    diff_cases = []
    for name, kw in K1_CONFIGS.items():
        if name == "iters2":  # the diff emit has no morphology
            continue
        for frames, bg0 in cases:
            for seed_bg in ((False, True) if name == "bench" else (False,)):
                diff_cases.append((name, frames, bg0, diff_kwargs(kw), seed_bg))
    # alpha 0 keeps the background at bg0 = k + 0.5: every magnitude a tie
    ties_bg = (np.floor(plate) + 0.5).astype(np.float32)
    diff_cases.append(("ties", clip[:16], ties_bg, dict(diff_kwargs(BENCH_KW), alpha=0.0), False))
    magnitudes = []
    for name, frames, bg0, dkw, seed_bg in diff_cases:
        f_gpu = torch.from_numpy(frames).to(dev)
        b_gpu = torch.from_numpy(bg0).to(dev)
        got = fused_segment(f_gpu, b_gpu, seed_bg=seed_bg, **dkw)
        ref = fused_segment_plain(f_gpu, b_gpu, seed_bg=seed_bg, **dkw)
        where = f"{name}, {tuple(frames.shape)}, seed_bg={seed_bg}"
        check_equal(err, "fused_segment_diff", zip(("magnitudes", "bg"), got, ref), where)
        magnitudes.append((where, got[0]))
    gen = torch.Generator().manual_seed(3)
    for shape in ((16, 1080, 1920), (5, 250, 333)):
        x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        magnitudes.append((f"random {shape}", x.to(dev)))
    for where, x in magnitudes:
        check_equal(err, "histogram_u8",
                    [("counts", histogram_u8(x), histogram_u8_plain(x).to(torch.float32))], where)
    say("k1_diff_and_k4_vs_plain", k1_diff_comparisons=len(diff_cases),
        k4_comparisons=len(magnitudes), bit_equal=True,
        tie_case_max_magnitude=int(magnitudes[len(diff_cases) - 1][1].max()))
    del magnitudes
    if k1_only:
        return k1_timing(clip, plate, card)

    # 3c. K1's padded_occ mode against its plain version, bit for bit: the
    # padded mask (zeros outside the image), occ128 and the background
    small, _a, _t, small_plate = multi_blob_clip(160, 240, 16, n_blobs=2, radius=46.0,
                                                 noise_sigma=2.0, seed=7)
    padded_cases = [("bench", BENCH_KW, clip[:16], plate.astype(np.float32)),
                    ("median3", K1_CONFIGS["median3"], clip[:16], plate.astype(np.float32)),
                    ("bench", BENCH_KW, cases[1][0], cases[1][1]),
                    ("iters2", K1_CONFIGS["iters2"], cases[1][0], cases[1][1])]
    for name in K1_REFUSED:
        fkw = _front_end_kwargs(k1_refused_config(bench_cfg(config, 8), name))
        if fkw["median_ksize"] in (0, 3):  # K1 takes it, split as k1_split says
            padded_cases.append((name, fkw, small, small_plate.astype(np.float32)))
    k1_padded = None
    for name, kw, frames, bg0 in padded_cases:
        f_gpu = torch.from_numpy(frames).to(dev)
        b_gpu = torch.from_numpy(bg0).to(dev)
        got = fused_segment(f_gpu, b_gpu, padded_occ=True, **kw)
        ref = fused_segment_plain(f_gpu, b_gpu, padded_occ=True, **kw)
        where = f"{name}, {tuple(frames.shape)}"
        check_equal(err, "fused_segment_padded_occ",
                    zip(("padded masks", "bg", "occ128"), got, ref), where)
        H, W = frames.shape[1:]
        if got[0][:, H:].any() or got[0][:, :, W:].any() or not got[2].any():
            raise AssertionError(f"K1 padded_occ: padding not zero or no occupancy ({where})")
        if name == "bench" and frames.shape[0] == 16:
            k1_padded = got
    say("k1_padded_occ_vs_plain", cases=[f"{n} {list(f.shape)}" for n, _k, f, _b in padded_cases],
        bit_equal=True, padded_shape=list(k1_padded[0].shape),
        occ128_shape=list(k1_padded[2].shape), occupied_blocks=int(k1_padded[2].sum()))

    # 3d. K7 against its plain version, bit for bit: k = 3, 5, 7 at batch
    # 256 and 1080p, 9 and 25 on the small clip, up to 437 on edge shapes,
    # 3-9 on ragged widths and adversarial frames; its SASS
    f256 = torch.from_numpy(clip[:256]).to(dev)
    say("k7_vs_plain", sass=median_sass(lib_path), **median_checks(f256, small, err))
    del f256

    # 4. K2 against its plain version, every stats field bit for bit
    masks_k2 = [("k1_masks", k1_masks)]
    for p in (0.05, 0.3):
        m = (torch.rand((16, 1080, 1920), generator=torch.Generator().manual_seed(int(p * 100)))
             < p).to(torch.uint8) * 255
        masks_k2.append((f"random_{p}", m.to(dev)))
    def k2_plain(m):  # K2's plain version: the sums, then the shared epilogue
        ref = _assemble_stats(*label_sums_plain(m, MAX_COMPONENTS), *m.shape[1:])
        return dict(ref, overflow=torch.zeros_like(ref["count"]))

    for name, m in masks_k2:
        got = label_stats(m, MAX_COMPONENTS)
        check_equal(err, "ccl_stats", ((k, got[k], k2_plain(m)[k]) for k in K2_KEYS), name)
    # K2 given the strip occupancy: of K1's padded masks from occ128 (the
    # staged route's handoff), of the random masks padded to 64 x 256, and
    # of an all-empty batch; against K2 deriving it and the plain version
    occ_cases = [("k1_padded_occ", k1_padded[0],
                  k1_padded[2].reshape(16, 576, 8, 2).amax(dim=3), masks_k2[0][1])]
    for name, m in masks_k2[1:] + [("empty", torch.zeros((4, 1080, 1920), dtype=torch.uint8,
                                                           device=dev))]:
        occ_cases.append((name, *padded_stats(m), m))
    for name, padded, occ, m in occ_cases:
        got = label_stats(padded, MAX_COMPONENTS, strip_occ=occ, H=1080, W=1920)
        derived = label_stats(m, MAX_COMPONENTS)
        ref = k2_plain(m)
        check_equal(err, "ccl_stats_occ", ((k, got[k], ref[k]) for k in K2_KEYS), name)
        check_equal(err, "ccl_stats", ((k, derived[k], ref[k]) for k in K2_KEYS),
                    f"{name}, derived")
    say("k2_vs_plain", scenes=[n for n, _ in masks_k2], bit_equal=True,
        strip_occ_scenes=[n for n, *_ in occ_cases],
        strip_occ_occupied=[round(float(o.float().mean()), 4) for _n, _p, o, _m in occ_cases])
    del occ_cases

    # 5. K3 against its plain version, bit for bit, 8- and 4-connected
    rng = np.random.default_rng(5)
    masks_k3 = masks_k2 + [
        ("u_shape", torch.from_numpy(u_shape(130, 280)[None]).to(dev)),
        ("mixed_scene", torch.from_numpy(mixed_scene()).to(dev)),
        ("odd_5x250x333", torch.from_numpy(((rng.random((5, 250, 333)) < 0.3) * 255)
                                           .astype(np.uint8)).to(dev)),
        ("odd_2x7x9", torch.from_numpy(((rng.random((2, 7, 9)) < 0.5) * 255)
                                       .astype(np.uint8)).to(dev)),
    ]
    # K3's occupancy skip: one occupied strip at each ragged edge,
    # components across tile and strip borders, every pixel, none; 4-
    # connected, components across segments and the strip border, diagonal
    # contacts across a tile corner, ragged H and W
    for H, W in ((71, 601), (70, 600)):
        masks_k3.append((f"edge_strips_{H}x{W}", torch.from_numpy(edge_strip_scene(H, W)).to(dev)))
    for H, W in ((45, 601), (48, 1024)):
        masks_k3.append((f"conn4_{H}x{W}", torch.from_numpy(conn4_scene(H, W)).to(dev)))
    # each scene, 8- and 4-connected: the labels, and the occupancy K3 hands
    # K6 equal to the labels'
    for name, m in masks_k3:
        for conn in (8, 4):
            got, occ = root_labels(m, conn)
            check_equal(err, "ccl_labels" if conn == 8 else "ccl_labels_conn4",
                        [("labels", got, label_components(m, conn)),
                         ("occupancy", occ, root_occupancy_plain(got, conn))],
                        f"{name}, connectivity {conn}")
    # K3 then K6 given K3's occupancy (connected_components_with_stats) on
    # the card against the CPU; the 4-connected run is the ops API's path
    # of K3 4-connected, whose launches the kernels line reports
    cc_batch = k1_masks[:2]
    for conn in (8, 4):
        reset_counts()
        got = connected_components_with_stats(cc_batch, MAX_COMPONENTS, conn)
        torch.cuda.synchronize()
        counts = read_counts()
        if (counts["ccl_labels"], counts["root_stats"], counts["root_stats_occ"],
                counts["ccl_labels_conn4"]) != (1, 1, 1, int(conn == 4)):
            raise AssertionError(f"connected_components_with_stats({conn}) launches: {counts}")
        if conn == 4:
            conn4_counts = counts
        ref = connected_components_with_stats(cc_batch.cpu(), MAX_COMPONENTS, conn)
        for k in CC_KEYS:
            if not torch.equal(got[k].cpu(), ref[k]):
                raise AssertionError(f"connected_components_with_stats {k} differs "
                                     f"between card and CPU (connectivity {conn})")
    say("k3_vs_plain", scenes=[n for n, _ in masks_k3], connectivity=[8, 4], bit_equal=True,
        occupancy_handed_to_k6_equal=True, cc_stats_cuda_equals_cpu=list(CC_KEYS),
        cc_stats_shape=list(cc_batch.shape), cc_stats_conn4_launches=conn4_counts)

    # 5a. K6 against its plain version, bit for bit: the raw outputs
    # (root_stats) at every option (sums, with the bbox, with the dense ids,
    # the ids alone as relabel_dense), and the whole stats dict
    # (root_stats_dict: bbox and labels each way, against root_stats_plain
    # then _stats_dict, the centroid's float bits included); both
    # connectivities, given K3's occupancy and deriving it; C = 1, 32 and
    # past shared memory on the small scenes, 32 on the 1080p ones
    n_k6 = 0
    for name, m in masks_k3:
        small_scene = m.shape[-1] < 1100
        for conn in (8, 4):
            root, occ = root_labels(m, conn)
            for C in ((1, MAX_COMPONENTS, 2000, 13000) if small_scene else (MAX_COMPONENTS,)):
                for given in (occ, None):
                    where = (f"{name}, connectivity {conn}, C={C}, "
                             f"{'given' if given is not None else 'deriving'} the occupancy")
                    for sums, bbox, labels in ROOT_STATS_OPTIONS:
                        ref = root_stats_plain(root, C, conn, sums, bbox, labels)
                        got = root_stats(root, C, conn, sums, bbox, labels, strip_occ=given)
                        check_equal(err, "root_stats", ((k, g, r) for k, g, r in zip(
                            ("count", "sums", "bbox extremes", "dense ids"), got, ref)
                            if r is not None), f"{where}, options {(sums, bbox, labels)}")
                        n_k6 += 1
                    for bbox, labels in ((False, False), (True, False), (False, True),
                                         (True, True)):
                        ref = _stats_dict(*root_stats_plain(root, C, conn, True, bbox, labels),
                                          *m.shape[1:])
                        got = root_stats_dict(root, C, conn, bbox, labels, strip_occ=given)
                        check_equal(err, "root_stats", ((k, got[k].view(torch.int32)
                                                         if k == "centroid" else got[k],
                                                         ref[k].view(torch.int32)
                                                         if k == "centroid" else ref[k])
                                                        for k in CC_KEYS),
                                    f"{where}, stats dict, bbox={bbox}, labels={labels}")
                        n_k6 += 1
    # the staged route's return_labels: K3's labels and occupancy through
    # relabel_dense (K6)
    cfg16 = bench_cfg(config, 16)
    reset_counts()
    _c, out = process_batch_staged(cfg16, init_carry(cfg16, 1080, 1920, plate, device=dev),
                                   torch.from_numpy(clip[:16]).to(dev), return_masks=True,
                                   return_labels=True, max_components=MAX_COMPONENTS)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["root_stats"] != 1 or counts["root_stats_occ"] != 1 or counts["ccl_labels"] != 1:
        raise AssertionError(f"process_batch_staged(return_labels=True) launches: {counts}")
    ref = root_stats_plain(label_components(out["masks"], 8), MAX_COMPONENTS, 8, False, False,
                           True)[3]
    check_equal(err, "root_stats", [("staged return_labels", out["labels"], ref)],
                "process_batch_staged, batch 16")
    say("k6_vs_plain", comparisons=n_k6, scenes=[n for n, _ in masks_k3], connectivity=[8, 4],
        options=[list(o) for o in ROOT_STATS_OPTIONS], bit_equal=True,
        staged_return_labels_bit_equal=True, staged_return_labels_launches=counts)
    del masks_k2, masks_k3, out

    # 5b. K5 against its plain version, bit for bit: the route's own
    # detections (bench front end and K2, two batches of 256), then the
    # synthetic streams
    cfg = bench_cfg(config, 256)
    t_kw = dict(max_dist=cfg.track.max_dist, death_patience=cfg.track.death_patience,
                assigner=cfg.track.assigner)
    state = init_track_state(cfg.track.max_tracks, dev)
    bg = torch.from_numpy(plate.astype(np.float32)).to(dev)
    route_rows = 0
    for b in range(clip.shape[0] // 256):
        masks_b, bg = fused_segment(torch.from_numpy(clip[256 * b:256 * (b + 1)]).to(dev), bg,
                                    **_front_end_kwargs(cfg))
        dets, _n, valid, _s = extract_detections(label_stats(masks_b, MAX_COMPONENTS),
                                                 cfg.segment.min_area, cfg.segment.max_blobs)
        if b == 0:
            route_dets = (dets, valid)
        state, _rows, rv = check_track_scan(err, state, dets, valid,
                                            torch.tensor(256 * b, dtype=torch.int32),
                                            f"route batch {b}", **t_kw)
        route_rows += int(rv.sum())
    del masks_b, bg
    n_k5 = 0
    k5_kernels = {}  # (T, D) -> [scan_plan's kernel, launches, launches of the table kernel]
    for kind in DET_KINDS:
        shapes = K5_SHAPES + ((K5_GLOBAL_SHAPE,) if kind == "cloud" else ())
        for T, D in shapes:
            n = 8 if (T, D) == K5_GLOBAL_SHAPE else 48
            dets, valid = det_sequence(kind, D, frames=n, seed=T + D)
            for assigner in ("greedy", "hungarian"):
                kept = track_scan.kept_launches
                check_track_scan(err, init_track_state(T, "cpu"), torch.from_numpy(dets),
                                 torch.from_numpy(valid), torch.tensor(2**24 - 20, dtype=torch.int32),
                                 f"{kind}, T={T}, D={D}, {assigner}", max_dist=40.0,
                                 death_patience=3, assigner=assigner)
                rec = k5_kernels.setdefault(f"{T}x{D}", [scan_plan(T, D).kernel, 0, 0])
                rec[1] += 1
                rec[2] += track_scan.kept_launches - kept
                n_k5 += 1
    # the tables past the register kernel launched the kept table kernel,
    # in shared memory (64 x 16) and in global scratch (600 x 100), every time
    for shape, (kernel, n, kept) in k5_kernels.items():
        if kept != (0 if kernel == "registers" else n):
            raise AssertionError(f"K5 at {shape}: {kept} of {n} launches took the table kernel, "
                                 f"scan_plan says {kernel}")
    if (k5_kernels["64x16"][0], k5_kernels["600x100"][0]) != ("shared", "global"):
        raise AssertionError(f"K5's large tables: {k5_kernels}")
    say("k5_vs_plain", route_batches=clip.shape[0] // 256, route_rows=route_rows,
        synthetic_scans=n_k5, kinds=list(DET_KINDS), shapes=[list(x) for x in K5_SHAPES],
        global_scratch_shape=list(K5_GLOBAL_SHAPE), kernels=k5_kernels, bit_equal=True)

    # 5c. configs K1 does not take: split around K1, or the median route
    # (K1b, K7, K1), on the card against the CPU; then a 1080p batch with
    # median 7
    refused, split_launches = {}, {"blur_u8": 0, "morph_u8": 0, "median_u8": 0}
    for name in K1_REFUSED:
        fcfg = k1_refused_config(bench_cfg(config, 8), name)
        median_k1 = fcfg.median is None or fcfg.median.ksize <= 3
        fkw = _front_end_kwargs(fcfg)
        parts = k1_split(*small.shape[1:], **fkw) if median_k1 else None
        # K1m's launches a batch: morph_plan's groups of the open and close
        n_morph = len(morph_plan(*small.shape[1:], open_close_steps(
            ((fkw["open_shape"], fkw["open_ksize"], fkw["open_iters"]),
             (fkw["close_shape"], fkw["close_ksize"], fkw["close_iters"])))))
        n_batches = -(-small.shape[0] // fcfg.batch)
        ref = process_clip(small, fcfg, background0=small_plate, max_components=MAX_COMPONENTS,
                           return_masks=True, device="cpu")
        for route in ("process_clip", "process_clip(use_pallas=True)", "StreamingPipeline"):
            reset_counts()
            if route == "StreamingPipeline":
                rows = StreamingPipeline(fcfg, max_components=MAX_COMPONENTS).run(
                    VideoMemory(small), background0=small_plate)
                same = rows == ref[0]
            else:
                rows, c_gpu, m_gpu = process_clip(
                    small, fcfg, background0=small_plate, max_components=MAX_COMPONENTS,
                    return_masks=True, use_pallas=route.endswith("True)"), device="cuda")
                same = (rows == ref[0] and np.array_equal(m_gpu, ref[2])
                        and torch.equal(c_gpu.bg.cpu(), ref[1].bg))
            torch.cuda.synchronize()
            counts = read_counts()
            for k in split_launches:
                split_launches[k] += counts[k]
            if median_k1:  # K1 a batch, and K1b (one launch) or K1m where k1_split says
                ok = (counts["fused_segment"] >= 2
                      and counts["blur_u8"] == n_batches * parts[0]
                      and counts["morph_u8"] == n_batches * n_morph * parts[1]
                      and counts["median_u8"] == 0)
            else:  # the median route: K1b, K7, K1 a batch; for Otsu K4 and the tail's K1m
                otsu = fcfg.segment.threshold == "otsu"
                ok = (counts["fused_segment"] == counts["blur_u8"] == counts["median_u8"]
                      == n_batches
                      and counts["morph_u8"] == n_batches * n_morph * otsu
                      and counts["histogram_u8"] == n_batches * otsu)
            if not ok or counts["track_scan"] < 2:
                raise AssertionError(f"{name} through {route}: launches {counts}")
            if not same:
                raise AssertionError(f"{name} through {route}: the card's run differs from the CPU's")
        refused[name] = dict(rows=len(ref[0]), k1_split=parts,
                             k1m_launches_a_batch=n_morph if parts and parts[1] else 0,
                             k7_launches_a_batch=int(not median_k1))
    # K1b and K1m against their plain versions on that path's inputs: the
    # small clip's frames at 65 taps, and its K1 masks under the 7 x 7 and
    # 33 SEs
    f_small = torch.from_numpy(small[:8]).to(dev)
    check_equal(err, "blur_u8", [("blurred", blur_u8(f_small, 65),
                                  gaussian_blur_u8(f_small, 65).to(torch.uint8))], "65 taps")
    m_small = fused_segment(f_small, torch.from_numpy(small_plate.astype(np.float32)).to(dev),
                            **dict(BENCH_KW, open_ksize=0, close_ksize=0))[0]
    for shape, k in (("rect", 7), ("ellipse", 33), ("rect", 33)):
        se = structuring_element(shape, k)
        for erode in (True, False):
            check_equal(err, "morph_u8", [("mask", morph_u8(m_small, se, erode),
                                           _morph(m_small, se, erode))],
                        f"{shape} {k}, erode={erode}")
    # the median route at 1080p: K1b, K7 and K1 on a 64-frame batch
    med7 = dataclasses.replace(cfg, median=config.MedianConfig(7), batch=64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    f_med7 = torch.from_numpy(clip[:64]).to(dev)
    _c, out = process_batch(med7, init_carry(med7, 1080, 1920, plate, device=dev), f_med7,
                            max_components=MAX_COMPONENTS)
    med7_rows = int(out["row_valid"].sum())
    med7_s = time.time() - t0
    med7_peak = torch.cuda.max_memory_allocated() / 2**30
    if not (out["rows"].shape == (64, 8, 5) and torch.isfinite(out["rows"]).all() and med7_rows):
        raise AssertionError("median 7 at 1080p: no rows, or rows not finite")
    # the card's filter prefix (K1b, K7) against the CPU's on the first
    # frames and the last
    med7_frames = [0, 1, 2, 3, 63]
    got = filter_batch(med7, f_med7.to(torch.float32))[med7_frames].cpu()
    if not torch.equal(got, filter_batch(med7, torch.from_numpy(clip[med7_frames]).to(torch.float32))):
        raise AssertionError("median 7 at 1080p: the card's filtered frames differ from the CPU's")
    say("k1_refused_configs", configs=refused, routes_equal_cpu=True, launches=split_launches,
        k1b_k1m_bit_equal=True, median7_1080p_frames=64, median7_1080p_rows=med7_rows,
        median7_1080p_seconds=round(med7_s, 3), median7_1080p_peak_device_gib=med7_peak,
        median7_frames_equal_cpu=med7_frames)
    del out, f_med7

    # 6. the staged route through the entry point
    reset_counts()
    t0 = time.time()
    rows, _carry, _ = process_clip(clip, cfg, background0=plate,
                                  max_components=MAX_COMPONENTS, use_pallas=True, device="cuda")
    torch.cuda.synchronize()
    slice_s = time.time() - t0
    staged_counts = read_counts()
    if min(staged_counts["fused_segment"], staged_counts["ccl_stats"],
           staged_counts["track_scan"]) < 2:
        raise AssertionError(f"a kernel of the staged route was not launched: {staged_counts}")
    # the padded handoff at 1080p: K1 in padded_occ mode, K2 given occ128's strips
    if (min(staged_counts["fused_segment_padded_occ"], staged_counts["ccl_stats_occ"]) < 2
            or staged_counts["fused_segment_padded_occ"] != staged_counts["fused_segment"]):
        raise AssertionError(f"the staged route did not take the padded handoff: {staged_counts}")
    csv_full = format_rows(rows).encode()
    if hashlib.sha256(csv_full).hexdigest() != REF_CSV_SHA256:
        with open(os.path.join(OUT_DIR, "tracks_512_gpu.csv"), "wb") as fh:
            fh.write(csv_full)
        raise AssertionError("slice rows differ from the OpenCV reference's "
                             f"(CSV written to {OUT_DIR}/tracks_512_gpu.csv)")
    arr = np.asarray(rows, np.float64)
    ids = sorted(set(arr[:, 0].astype(int)))
    # distance of every row to the nearest true blob centre, and the share
    # of (frame, blob) pairs some row finds within 1 px
    d = np.linalg.norm(truth[arr[:, 1].astype(int)] - arr[:, None, 2:4], axis=2).min(axis=1)
    found = np.zeros(truth.shape[:2], bool)
    for r in arr:
        found[int(r[1])] |= np.linalg.norm(truth[int(r[1])] - r[2:4], axis=1) < 1.0
    if not (np.isfinite(arr).all() and (d < 1.0).mean() >= 0.75 and found.mean() >= 0.75):
        raise AssertionError(f"rows far from the clip's truth: {(d < 1.0).mean()}, {found.mean()}")
    # 48-frame sub-clip: plain versions on the CPU vs kernels on the card
    sub_cfg = bench_cfg(config, 16)
    rows_cpu, carry_cpu, masks_cpu = process_clip(
        clip[:48], sub_cfg, background0=plate, max_components=MAX_COMPONENTS,
        use_pallas=True, device="cpu", return_masks=True)
    rows_gpu, carry_gpu, masks_gpu = process_clip(
        clip[:48], sub_cfg, background0=plate, max_components=MAX_COMPONENTS,
        use_pallas=True, device="cuda", return_masks=True)
    csv = {}
    for name, r in (("cpu", rows_cpu), ("gpu", rows_gpu)):
        path = os.path.join(OUT_DIR, f"tracks_48_{name}.csv")
        write_tracks_csv(path, r)
        with open(path, "rb") as fh:
            csv[name] = fh.read()
    if rows_cpu != rows_gpu or csv["cpu"] != csv["gpu"] or not np.array_equal(masks_cpu, masks_gpu):
        raise AssertionError("48-frame sub-clip: CPU and GPU rows/CSV/masks differ")
    if not torch.equal(carry_cpu.bg, carry_gpu.bg.cpu()):
        raise AssertionError("48-frame sub-clip: CPU and GPU backgrounds differ")
    if [r for r in rows if r[1] < 48] != rows_gpu:
        raise AssertionError("first 48 frames of the batch-256 run differ from the batch-16 run")
    say("slice", route="process_clip(use_pallas=True): K1 + K2", frames=int(clip.shape[0]),
        rows=len(rows), track_ids=len(ids), rows_equal_opencv_reference=True,
        rows_within_1px_of_truth=float((d < 1.0).mean()),
        blob_frames_found_within_1px=float(found.mean()),
        seconds=round(slice_s, 3), launches=staged_counts,
        sub_clip_cpu_gpu_rows_equal=True, sub_clip_csv_bytes_equal=True,
        sub_clip_csv_bytes=len(csv["gpu"]))

    # 7. the streamed default route (torch front end, K3, stats), the
    # streamed staged route, and a stopped-and-resumed run
    def stream(what, video=None, natives=None, **kw):
        """One StreamingPipeline run of the whole clip (video, else a
        VideoMemory of it) on cuda: (CSV bytes, seconds, launch counts read
        around it, peak device GiB); natives gets whether each of its
        stagers took the native feeder."""
        sp = StreamingPipeline(cfg, max_components=MAX_COMPONENTS, **kw)
        feeders = record_feeders(sp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        out = sp.run(VideoMemory(clip) if video is None else video, background0=plate)
        torch.cuda.synchronize()
        s = time.time() - t0
        counts = read_counts()
        if natives is not None:
            natives += feeders
        peak = torch.cuda.max_memory_allocated() / 2**30
        data = format_rows(out).encode()
        if hashlib.sha256(data).hexdigest() != REF_CSV_SHA256:
            with open(os.path.join(OUT_DIR, f"tracks_512_{what}.csv"), "wb") as fh:
                fh.write(data)
            raise AssertionError(f"streamed {what} rows differ from the OpenCV reference's")
        return data, s, counts, peak

    _csv, stream_s, default_counts, default_peak = stream("default")
    # K3, then K6 given K3's occupancy, a batch
    if (min(default_counts["ccl_labels"], default_counts["fused_segment"],
            default_counts["root_stats_occ"], default_counts["track_scan"]) < 2
            or default_counts["ccl_stats"]
            or default_counts["root_stats"] != default_counts["ccl_labels"]):
        raise AssertionError(f"streamed default route launches: {default_counts}")
    _csv, stream_staged_s, stream_staged_counts, staged_peak = stream("staged", use_pallas=True)
    if (stream_staged_counts["ccl_labels"] or stream_staged_counts["root_stats"]
            or min(stream_staged_counts["fused_segment"],
                                                  stream_staged_counts["ccl_stats"],
                                                  stream_staged_counts["fused_segment_padded_occ"],
                                                  stream_staged_counts["ccl_stats_occ"],
                                                  stream_staged_counts["track_scan"]) < 2):
        raise AssertionError(f"streamed use_pallas route launches: {stream_staged_counts}")
    if default_counts["fused_segment_padded_occ"] or default_counts["ccl_stats_occ"]:
        raise AssertionError(f"streamed default route launches: {default_counts}")
    ckpt = os.path.join(OUT_DIR, "stream_ckpt.npz")
    if os.path.exists(ckpt):
        os.unlink(ckpt)
    first = StreamingPipeline(cfg, max_components=MAX_COMPONENTS, checkpoint_path=ckpt,
                              checkpoint_every=1)
    first.run(VideoMemory(clip[:256]), background0=plate)
    resumed = StreamingPipeline(cfg, max_components=MAX_COMPONENTS, checkpoint_path=ckpt,
                                checkpoint_every=1).run(VideoMemory(clip), background0=plate)
    if hashlib.sha256(format_rows(resumed).encode()).hexdigest() != REF_CSV_SHA256:
        raise AssertionError("stopped-and-resumed streamed run differs from the reference")
    # K3 against its plain version on the route's own batch-256 masks
    N = 256
    frames = torch.from_numpy(clip[:N]).to(dev)
    bg0 = torch.from_numpy(plate.astype(np.float32)).to(dev)
    _c, out = process_batch(cfg, init_carry(cfg, 1080, 1920, plate, device=dev), frames,
                            return_masks=True, max_components=MAX_COMPONENTS)
    route_masks = out["masks"]
    del out
    for conn in (8, 4):
        check_equal(err, "ccl_labels",
                    [("labels", label_components_tiled(route_masks, conn),
                      label_components(route_masks, conn))],
                    f"streamed route masks, batch 256, connectivity {conn}")
    say("stream", route="StreamingPipeline.run -> process_batch: K1 + K3",
        frames=int(clip.shape[0]),
        csv_sha256_equals_reference=True, seconds=round(stream_s, 3), launches=default_counts,
        peak_device_gib=default_peak, staged_seconds=round(stream_staged_s, 3),
        staged_launches=stream_staged_counts, staged_peak_device_gib=staged_peak,
        resumed_csv_bytes_equal=True, k3_bit_equal_on_route_masks=True)

    # 7c. staging: the streamed default route fed by the native feeder (the
    # C++ ring), every staged batch of both feeders against the CPU's, and
    # the route fed by a ParallelVideoReader of 4 workers
    t0 = time.time()
    native_feeders = []
    _csv, native_s, native_counts, _peak = stream(
        "default_native", video=cycled(VideoBase, clip, clip.shape[0]), natives=native_feeders)
    if native_feeders != [True]:
        raise AssertionError(f"a decoder's frames did not take the native feeder: {native_feeders}")
    if (min(native_counts["ccl_labels"], native_counts["fused_segment"],
            native_counts["root_stats_occ"], native_counts["track_scan"]) < 2
            or native_counts["ccl_stats"]
            or native_counts["root_stats"] != native_counts["ccl_labels"]):
        raise AssertionError(f"streamed default route (native feeder) launches: {native_counts}")
    tail = VideoMemory(clip[:300])  # a full batch, then 44 frames padded to 256
    ref_batches = []
    cpu_stager = BatchStager(tail, 256, device="cpu")
    try:
        ref_batches = [(n, b.numpy()) for n, b in cpu_stager]
    finally:
        cpu_stager.close()
    staged_batches = {}
    for feeder in ("python", "native"):
        gpu_stager = BatchStager(tail, 256, queue_depth=1, device=dev,
                                 use_native=feeder == "native")
        got = []
        try:
            for n, b in gpu_stager:
                time.sleep(0.05)  # a slow consumer: the producer refills the ring
                got.append((n, b.cpu().numpy()))
        finally:
            gpu_stager.close()
        if [n for n, _ in got] != [256, 44] or [n for n, _ in ref_batches] != [256, 44]:
            raise AssertionError(f"{feeder} feeder batches: {[n for n, _ in got]}")
        for (_, a), (_, r) in zip(got, ref_batches):
            if not np.array_equal(a, r):
                raise AssertionError(f"a batch of the {feeder} feeder differs from the CPU's")
        staged_batches[feeder] = len(got)
    del got, ref_batches
    reader = ParallelVideoReader(lambda: VideoMemory(clip), workers=4, chunk=64)
    try:
        sp = StreamingPipeline(cfg, max_components=MAX_COMPONENTS)
        pr_feeders = record_feeders(sp)
        reset_counts()
        pr_t0 = time.time()
        pr_rows = sp.run(reader, background0=plate)
        torch.cuda.synchronize()
        pr_s = time.time() - pr_t0
    finally:
        reader.close()
    pr_counts = read_counts()
    if hashlib.sha256(format_rows(pr_rows).encode()).hexdigest() != REF_CSV_SHA256:
        raise AssertionError("rows through ParallelVideoReader differ from the reference's")
    if pr_feeders != [True]:
        raise AssertionError(f"ParallelVideoReader's frames did not take the ring: {pr_feeders}")
    if min(pr_counts["fused_segment"], pr_counts["ccl_labels"], pr_counts["root_stats_occ"],
           pr_counts["track_scan"]) < 2:
        raise AssertionError(f"streamed route through ParallelVideoReader launches: {pr_counts}")
    say("staging_checks", route="StreamingPipeline.run -> process_batch: K1 + K3",
        native_csv_sha256_equals_reference=True, native_seconds=round(native_s, 3),
        native_launches=native_counts, batches_bit_equal_cpu=staged_batches,
        parallel_reader_workers=4, parallel_reader_csv_sha256_equals_reference=True,
        parallel_reader_seconds=round(pr_s, 3), parallel_reader_launches=pr_counts,
        decoder_and_parallel_reader_took_native_feeder=True,
        process_clip_through_ring_csv_sha256_equals_reference=True,  # phase 6
        seconds=round(time.time() - t0, 1))

    # 7b. the Otsu routes: staged (K1's diff emit, K4, K2) and streamed
    # default (K1's diff emit, K4, K3)
    otsu_cfg = bench_cfg(config, 256, "otsu")

    def otsu_run(what, run):
        """One run of the whole clip on cuda: (rows, seconds, launch counts
        read around it); raises unless the CSV is REF_OTSU_CSV_SHA256's."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        rows = run()
        torch.cuda.synchronize()
        s = time.time() - t0
        counts = read_counts()
        data = format_rows(rows).encode()
        if hashlib.sha256(data).hexdigest() != REF_OTSU_CSV_SHA256:
            with open(os.path.join(OUT_DIR, f"tracks_512_{what}.csv"), "wb") as fh:
                fh.write(data)
            raise AssertionError(f"{what} rows differ from the reference's Otsu rows")
        return rows, s, counts

    def otsu_staged():
        return process_clip(clip, otsu_cfg, background0=plate, max_components=MAX_COMPONENTS,
                            use_pallas=True, device="cuda")[0]

    def otsu_stream():
        return StreamingPipeline(otsu_cfg, max_components=MAX_COMPONENTS).run(
            VideoMemory(clip), background0=plate)

    # the Otsu tail's open and close: K1m, a launch a morph_plan group a batch
    otsu_batches = -(-clip.shape[0] // otsu_cfg.batch)
    otsu_tail_groups = len(morph_plan(1080, 1920, open_close_steps(_morph_stages(otsu_cfg))))
    otsu_rows, otsu_staged_s, otsu_staged_counts = otsu_run("otsu_staged", otsu_staged)
    if (min(otsu_staged_counts["fused_segment"], otsu_staged_counts["histogram_u8"],
            otsu_staged_counts["ccl_stats"], otsu_staged_counts["track_scan"]) < 2
            or otsu_staged_counts["ccl_labels"] or otsu_staged_counts["ccl_stats_occ"]
            or otsu_staged_counts["root_stats"]
            or otsu_staged_counts["fused_segment_padded_occ"]
            or otsu_staged_counts["morph_u8"] != otsu_batches * otsu_tail_groups):
        raise AssertionError(f"staged Otsu route launches: {otsu_staged_counts}")
    _rows, otsu_stream_s, otsu_stream_counts = otsu_run("otsu_stream", otsu_stream)
    if (min(otsu_stream_counts["fused_segment"], otsu_stream_counts["histogram_u8"],
            otsu_stream_counts["ccl_labels"], otsu_stream_counts["root_stats_occ"],
            otsu_stream_counts["track_scan"]) < 2 or otsu_stream_counts["ccl_stats"]
            or otsu_stream_counts["morph_u8"] != otsu_batches * otsu_tail_groups):
        raise AssertionError(f"streamed Otsu route launches: {otsu_stream_counts}")
    sub_otsu = bench_cfg(config, 16, "otsu")
    rows_cpu, carry_cpu, masks_cpu = process_clip(
        clip[:48], sub_otsu, background0=plate, max_components=MAX_COMPONENTS,
        use_pallas=True, device="cpu", return_masks=True)
    rows_gpu, carry_gpu, masks_gpu = process_clip(
        clip[:48], sub_otsu, background0=plate, max_components=MAX_COMPONENTS,
        use_pallas=True, device="cuda", return_masks=True)
    if rows_cpu != rows_gpu or not np.array_equal(masks_cpu, masks_gpu):
        raise AssertionError("48-frame Otsu sub-clip: CPU and GPU rows/masks differ")
    if not torch.equal(carry_cpu.bg, carry_gpu.bg.cpu()):
        raise AssertionError("48-frame Otsu sub-clip: CPU and GPU backgrounds differ")
    if [r for r in otsu_rows if r[1] < 48] != rows_gpu:
        raise AssertionError("first 48 frames of the batch-256 Otsu run differ from the batch-16 run")
    say("otsu", routes=["process_clip(use_pallas=True): K1 diff + K4 + K2",
                        "StreamingPipeline.run -> process_batch: K1 diff + K4 + K3"],
        frames=int(clip.shape[0]), rows=len(otsu_rows),
        track_ids=len({int(r[0]) for r in otsu_rows}), csv_sha256_equals_reference=True,
        staged_seconds=round(otsu_staged_s, 3), staged_launches=otsu_staged_counts,
        stream_seconds=round(otsu_stream_s, 3), stream_launches=otsu_stream_counts,
        k1m_launches_a_batch=otsu_tail_groups,
        sub_clip_cpu_gpu_rows_masks_bg_equal=True, sub_clip_rows=len(rows_gpu))

    # 7g. the median route at full width: the bench config with median 5
    # and 15 through process_clip and StreamingPipeline (twice), each run's
    # CSV sha256 equal to its pin; K1b, K7, K1 and K5 once a batch, no K1m
    # and no torch morphology
    med_runs = median_route(clip, plate, cfg, {n: counters[n] for n in (
        "fused_segment", "blur_u8", "median_u8", "track_scan", "morph_u8")})
    say("median_route", frames=int(clip.shape[0]), **med_runs)

    # 7d. config 5: MS_STREAMS streams through MultiStreamPipeline, K1 and
    # K5 a launch a step for all streams
    ms_line, ms_kernels = multistream_phase(clip, plate, card, cfg, err)
    say("multistream", **ms_line)
    torch.cuda.empty_cache()

    # 7e. the filter chain: every filter on the card against the CPU, the
    # EDT and mask_boundary, the chain route at full width, a stateful chain
    filters_line, filters_launches, filter_kernels = filters_phase(clip, plate, card, cfg, err)
    say("filters", **filters_line)
    say("filters_launches", **filters_launches)
    say("filter_kernels", card=card, **filter_kernels)
    torch.cuda.empty_cache()

    # 7f. the multi-card half of dist/ on the one card: four bands of the
    # ('space',) mesh, a checkpoint resumed on one card, the ('stream',) mesh
    spatial_line, kb_kernels = spatial_phase(clip, plate, card, cfg, err)
    say("spatial", **spatial_line)
    torch.cuda.empty_cache()

    # 7h. tpuva's chip checks and BASELINE configs 1-3: each case through
    # the staged and the streamed default routes at its pinned CSV bytes
    t0 = time.time()
    say("configs", cases=configs_phase(clip_futures, counters), card=card,
        seconds=round(time.time() - t0, 1))
    torch.cuda.empty_cache()

    # 7i. BASELINE config 4 at 100k frames: the soak, killed and resumed
    say("soak", card=card, **soak_phase(counters))
    torch.cuda.empty_cache()

    # 7j. the scanned background (parallel_bg): KS against its plain
    # version, the scanned routes at REF_SCANNED_CSV_SHA256, the front end
    scanned_line, ks_kernel = scanned_phase(clip, plate, card, cfg, err, counters)
    say("scanned", **scanned_line)
    torch.cuda.empty_cache()

    # 8. at the main path's shapes (batch 256, 1080p): kernel vs plain
    # once more, then timing
    kw = _front_end_kwargs(cfg)
    masks, bg_last = fused_segment(frames, bg0, **kw)
    check_equal(err, "fused_segment",
                zip(("masks", "bg"), (masks, bg_last), fused_segment_plain(frames, bg0, **kw)),
                "main path, batch 256")
    got = label_stats(masks, MAX_COMPONENTS)
    ref = k2_plain(masks)
    check_equal(err, "ccl_stats", ((k, got[k], ref[k]) for k in K2_KEYS), "main path, batch 256")
    # the padded handoff at batch 256: K1's padded masks and occ128, K2 on
    # their strips; a random mask of density 0.3 (every strip occupied)
    padded, bg_padded, occ128 = fused_segment(frames, bg0, padded_occ=True, **kw)
    check_equal(err, "fused_segment_padded_occ",
                zip(("padded masks", "bg", "occ128"), (padded, bg_padded, occ128),
                    fused_segment_plain(frames, bg0, padded_occ=True, **kw)),
                "main path, batch 256")
    strip_occ = occ128.reshape(N, 576, 8, 2).amax(dim=3)
    check_equal(err, "ccl_stats_occ",
                ((k, label_stats(padded, MAX_COMPONENTS, strip_occ=strip_occ, H=1080,
                                 W=1920)[k], ref[k]) for k in K2_KEYS), "main path, batch 256")
    dense = torch.rand((N, 1080, 1920), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(30)) < 0.3
    dense = dense.to(torch.uint8) * 255
    dense_padded, dense_occ = padded_stats(dense)
    every_strip = torch.ones_like(strip_occ)
    dense_ref = label_stats(dense, MAX_COMPONENTS)
    for what, got in (
            ("given", label_stats(dense_padded, MAX_COMPONENTS, strip_occ=dense_occ, H=1080,
                                  W=1920)),
            ("every strip", label_stats(padded, MAX_COMPONENTS, strip_occ=every_strip, H=1080,
                                        W=1920))):
        base = dense_ref if what == "given" else ref
        check_equal(err, "ccl_stats_occ", ((k, got[k], base[k]) for k in K2_KEYS),
                    f"density 0.3 / clip, batch 256, strips {what}")
    diff_kw = _diff_kwargs(otsu_cfg)
    du8, bg_diff = fused_segment(frames, bg0, **diff_kw)
    check_equal(err, "fused_segment_diff",
                zip(("magnitudes", "bg"), (du8, bg_diff), fused_segment_plain(frames, bg0, **diff_kw)),
                "main path, batch 256")
    check_equal(err, "histogram_u8",
                [("counts", histogram_u8(du8), histogram_u8_plain(du8).to(torch.float32))],
                "main path, batch 256")
    del route_masks, got, ref
    reps = 5
    t = {}
    t["k1_plans"] = k1_plans(1080, 1920, (("k1", kw), ("k1_diff", diff_kw)))
    t["k1_ms"] = cuda_ms(lambda: fused_segment(frames, bg0, **kw), reps)
    t["k1_plain_ms"] = cuda_ms(lambda: fused_segment_plain(frames, bg0, **kw), 2)
    t["k1_padded_occ_ms"] = cuda_ms(lambda: fused_segment(frames, bg0, padded_occ=True, **kw),
                                    reps)
    t["k1_padded_occ_plain_ms"] = cuda_ms(
        lambda: fused_segment_plain(frames, bg0, padded_occ=True, **kw), 2)
    # K2: given K1's occupancy, deriving it from the cropped mask, and given
    # every strip (the walk of every strip before the kernels skipped); on
    # the clip and on density 0.3
    t["k2_occ_ms"] = cuda_ms(lambda: label_stats(padded, MAX_COMPONENTS, strip_occ=strip_occ,
                                                 H=1080, W=1920), reps)
    t["k2_ms"] = cuda_ms(lambda: label_stats(masks, MAX_COMPONENTS), reps)
    t["k2_every_strip_ms"] = cuda_ms(lambda: label_stats(
        padded, MAX_COMPONENTS, strip_occ=every_strip, H=1080, W=1920), reps)
    t["k2_plain_ms"] = cuda_ms(
        lambda: _assemble_stats(*label_sums_plain(masks, MAX_COMPONENTS), 1080, 1920), 2)
    t["k2_dense_occ_ms"] = cuda_ms(lambda: label_stats(
        dense_padded, MAX_COMPONENTS, strip_occ=dense_occ, H=1080, W=1920), reps)
    # K2's launches a call and device time (torch.profiler), and its grid
    for name, fn in (("k2_occ", lambda: label_stats(padded, MAX_COMPONENTS, strip_occ=strip_occ,
                                                     H=1080, W=1920)),
                     ("k2", lambda: label_stats(masks, MAX_COMPONENTS)),
                     ("k2_dense_occ", lambda: label_stats(dense_padded, MAX_COMPONENTS,
                                                          strip_occ=dense_occ, H=1080, W=1920))):
        kernels = kernel_breakdown(fn)
        t[f"{name}_device_ms"], t[f"{name}_launches"] = device_summary(kernels)
        t[f"{name}_kernels"] = kernels
    # K6's launches a call (its kernel, and any other kernel: a torch op)
    # and device time, given K3's occupancy and deriving it (torch.profiler;
    # here, beside K2's, where the profiler saw them: after the timings
    # below it saw no kernel of K6's calls in one run)
    root, root_occ = root_labels(masks, 8)
    k6_kw = dict(compute_bbox=False, compute_labels=False)
    for name, fn in (("k6_occ", lambda: _stats_from_root(root, MAX_COMPONENTS, 8,
                                                         strip_occ=root_occ, **k6_kw)),
                     ("k6", lambda: _stats_from_root(root, MAX_COMPONENTS, 8, **k6_kw))):
        kernels = kernel_breakdown(fn)
        t[f"{name}_device_ms"], _n = device_summary(kernels)
        t[f"{name}_kernel_launches"], t[f"{name}_torch_op_launches"] = k6_launches(kernels)
        before = root_stats.launches
        fn()
        t[f"{name}_counted_launches"] = root_stats.launches - before  # the wrapper's count
    del root
    t["k2_grid"] = dict(zip(("blocks_per_sm", "sms"), k2_grid()))
    t["k2_dense_ms"] = cuda_ms(lambda: label_stats(dense, MAX_COMPONENTS), reps)
    t["k2_dense_every_strip_ms"] = cuda_ms(lambda: label_stats(
        dense_padded, MAX_COMPONENTS, strip_occ=torch.ones_like(dense_occ), H=1080, W=1920),
        reps)
    t["clip_strips_occupied"] = float(strip_occ.float().mean())
    t["dense_strips_occupied"] = float(dense_occ.float().mean())
    t["k3_dense_ms"] = cuda_ms(lambda: label_components_tiled(dense, 8), reps)
    # K3 4-connected on density 0.3, bit-equal first
    check_equal(err, "ccl_labels_conn4", [("labels", label_components_tiled(dense[:16], 4),
                                           label_components(dense[:16], 4))],
                "density 0.3, 16 frames")
    t["k3_conn4_dense_ms"] = cuda_ms(lambda: label_components_tiled(dense, 4), reps)
    del dense, dense_padded
    t["k3_ms"] = cuda_ms(lambda: label_components_tiled(masks, 8), reps)
    t["k3_plain_ms"] = cuda_ms(lambda: label_components(masks, 8), 2)
    check_equal(err, "ccl_labels_conn4", [("labels", label_components_tiled(masks, 4),
                                           label_components(masks, 4))], "main path, batch 256")
    t["k3_conn4_ms"] = cuda_ms(lambda: label_components_tiled(masks, 4), reps)
    t["k3_conn4_plain_ms"] = cuda_ms(lambda: label_components(masks, 4), 2)
    cc_kw = dict(compute_bbox=False, compute_labels=False)
    t["cc_stats_ms"] = cuda_ms(lambda: connected_components_with_stats(
        masks, MAX_COMPONENTS, **cc_kw), reps)
    t["cc_stats_conn4_ms"] = cuda_ms(lambda: connected_components_with_stats(
        masks, MAX_COMPONENTS, 4, **cc_kw), reps)
    # K6 alone on K3's root-key labels, as the route calls it (no bbox, no
    # labels): given K3's occupancy, deriving it, with the dense ids, and
    # its plain version (the torch ops the route ran before K6)
    root, root_occ = root_labels(masks, 8)
    k6_kw = dict(compute_bbox=False, compute_labels=False)
    check_equal(err, "root_stats", ((k, _stats_from_root(root, MAX_COMPONENTS, 8, strip_occ=root_occ,
                                                         **k6_kw)[k],
                                     _stats_from_root_plain(root, MAX_COMPONENTS, 8, **k6_kw)[k])
                                    for k in STAT_KEYS), "main path, batch 256")
    t["k6_occ_ms"] = cuda_ms(lambda: _stats_from_root(root, MAX_COMPONENTS, 8,
                                                      strip_occ=root_occ, **k6_kw), reps)
    t["k6_ms"] = cuda_ms(lambda: _stats_from_root(root, MAX_COMPONENTS, 8, **k6_kw), reps)
    t["k6_labels_occ_ms"] = cuda_ms(lambda: _stats_from_root(
        root, MAX_COMPONENTS, 8, compute_bbox=False, compute_labels=True, strip_occ=root_occ),
        reps)
    t["k6_plain_ms"] = cuda_ms(lambda: _stats_from_root_plain(root, MAX_COMPONENTS, 8, **k6_kw),
                               reps)
    root_occupied_px = int(root_occ.sum()) * STRIP_PX
    del root
    t["k1_diff_ms"] = cuda_ms(lambda: fused_segment(frames, bg0, **diff_kw), reps)
    t["k1_diff_plain_ms"] = cuda_ms(lambda: fused_segment_plain(frames, bg0, **diff_kw), 2)
    t["k4_ms"] = cuda_ms(lambda: histogram_u8(du8), reps)
    t["k4_plain_ms"] = cuda_ms(lambda: histogram_u8_plain(du8), 2)
    # the library yardstick: one torch.bincount over frame-offset keys
    keys = (du8.reshape(N, -1).to(torch.int32)
            + 256 * torch.arange(N, dtype=torch.int32, device=dev)[:, None]).reshape(-1)
    if not torch.equal(torch.bincount(keys, minlength=256 * N).reshape(N, 256).to(torch.float32),
                       histogram_u8(du8)):
        raise AssertionError("torch.bincount over frame-offset keys differs from K4")
    t["k4_library_ms"] = cuda_ms(lambda: torch.bincount(keys, minlength=256 * N), reps)
    del keys
    # the Otsu tail's open and close on the batch's Otsu masks: K1m
    # (open_close_u8, the routes' call) against the torch ops the routes
    # ran before (morph_steps_plain), bit-equal first
    omask = torch.where(du8.to(torch.int32) > otsu_threshold(du8).to(torch.int32)[:, None, None],
                        255, 0).to(torch.uint8)
    tail_stages = _morph_stages(otsu_cfg)
    check_equal(err, "morph_u8", [("otsu tail", open_close_u8(omask, tail_stages),
                                   morph_steps_plain(omask, open_close_steps(tail_stages)))],
                "the Otsu masks, batch 256")
    t["otsu_tail_k1m_ms"] = cuda_ms(lambda: open_close_u8(omask, tail_stages), reps)
    t["otsu_tail_torch_ms"] = cuda_ms(
        lambda: morph_steps_plain(omask, open_close_steps(tail_stages)), 2)
    t["otsu_tail_k1m_launches"] = otsu_tail_groups
    del omask
    # K7 at the median route's windows, its plain version and the library call
    t.update(median_timing(frames, err, reps))
    t.update(time_k5(cfg, masks, bg_last, plate, route_dets, err, reps))
    t["k5_kernel"] = scan_plan(cfg.track.max_tracks, cfg.segment.max_blobs)._asdict()
    # K1m and K1b: wide_calls (--wide times them too), each checked bit for
    # bit first; beside them the plan, the 10-step group's launches, the
    # plain versions and max_pool2d against the 7 x 7 rect dilate
    t["k1b_plan"] = blur_plan(1080, 1920, blur_taps(65)[0])._asdict()
    t.update(time_wide_calls(wide_calls(frames, bg0, masks, kw), err, reps))
    t["k1b_plain_ms"] = cuda_ms(lambda: gaussian_blur_u8(frames, 65).to(torch.uint8), 2)
    se7 = structuring_element("rect", 7)
    before = morph_u8.launches
    morph_steps(masks, [(se7, True)] * 5 + [(se7, False)] * 5)
    t["k1m_group10_launches"] = morph_u8.launches - before
    masks_f = masks[:, None].to(torch.float32)
    pooled = torch.nn.functional.max_pool2d(masks_f, 7, stride=1, padding=3)
    if not torch.equal(pooled[:, 0].to(torch.uint8), morph_u8(masks, se7, False)):
        raise AssertionError("max_pool2d differs from K1m's 7 x 7 dilate")
    del pooled
    t["k1m_plain_ms"] = cuda_ms(lambda: _morph(masks, se7, False), 2)
    t["k1m_library_ms"] = cuda_ms(
        lambda: torch.nn.functional.max_pool2d(masks_f, 7, stride=1, padding=3), reps)
    del masks_f
    reach120_kw = dict(kw, open_ksize=7, open_iters=10, close_ksize=7, close_iters=10)
    reach120_steps = open_close_steps((("rect", 7, 10), ("rect", 7, 10)))
    t["k1_split_reach120_parts"] = list(k1_split(1080, 1920, **reach120_kw))
    t["k1_split_reach120_k1m_launches"] = len(morph_plan(1080, 1920, reach120_steps))
    t["k1_split_blur65_parts"] = list(k1_split(1080, 1920, **dict(kw, blur_ksize=65)))
    # both streamed routes in turns: default, staged, staged, default
    t["stream_default_fps"], t["stream_staged_fps"] = [], []
    for route in ("default", "staged", "staged", "default"):
        s = stream(route, use_pallas=route == "staged")[1]
        t[f"stream_{route}_fps"].append(clip.shape[0] / s)
    # the Otsu routes: the runs of phase 7b, then one more each
    t["otsu_staged_fps"] = [clip.shape[0] / otsu_staged_s,
                            clip.shape[0] / otsu_run("otsu_staged", otsu_staged)[1]]
    t["otsu_stream_fps"] = [clip.shape[0] / otsu_stream_s,
                            clip.shape[0] / otsu_run("otsu_stream", otsu_stream)[1]]
    px = masks.numel()
    occupied_px = int(strip_occ.sum()) * STRIP_PX
    bounds = {
        # frames read, masks written, background read and written once
        "fused_segment": bound(frames.numel() + px + 2 * 4 * bg0.numel(),
                               k1_ops_per_px(kw) * px),
        # frames read, the padded masks and occ128 written, background
        # read and written once
        "fused_segment_padded_occ": bound(frames.numel() + padded.numel() + occ128.numel()
                                          + 2 * 4 * bg0.numel(), k1_ops_per_px(kw) * px),
        # the mask read (to derive the occupancy); the stats are a few KB
        "ccl_stats": bound(px, CCL_OPS_PER_PX * px),
        # the occupancy read, the mask of the occupied strips read
        "ccl_stats_occ": bound(strip_occ.numel() + occupied_px, CCL_OPS_PER_PX * occupied_px),
        # the mask read and the int32 labels written
        "ccl_labels": bound(px + 4 * px, CCL_OPS_PER_PX * px),
        "ccl_labels_conn4": bound(px + 4 * px, CCL_OPS_PER_PX * px),
        # frames read, magnitudes written, background read and written once
        "fused_segment_diff": bound(frames.numel() + du8.numel() + 2 * 4 * bg0.numel(),
                                    k1_ops_per_px(diff_kw) * du8.numel()),
        # the magnitudes read, the int32 counts written; one add a pixel
        "histogram_u8": bound(du8.numel() + 4 * 256 * N, du8.numel()),
        # detections (12 B) and valid flags read, rows (20 B) and flags
        # written, the state read and written once
        "track_scan": bound(route_dets[0].numel() * 4 + route_dets[1].numel()
                            + route_dets[1].numel() * (20 + 1)
                            + 2 * (cfg.track.max_tracks * 17 + 4),
                            k5_ops(cfg.track.max_tracks, cfg.segment.max_blobs, N)),
    }
    # K1b: frames read, blurred frames written, blur_ops_per_px(65); K1m:
    # the mask read and written once a launch, a separable 7 x 7 min or max
    # (2 x 6 a pixel) a step: one step, the 10-step group, and reach 120's
    # launches (10 steps each)
    bounds["blur_u8"] = bound(2 * px, blur_ops_per_px(65) * px)
    bounds["morph_u8"] = bound(2 * px, 2 * (7 - 1) * px)
    # (the groups' operations only where this run's data needs them: at the
    # pixels within a launch's summed reach, 30, of the masks' foreground;
    # farther ones stay 0)
    t["k1m_near_share_30"] = near_share(masks, 30)
    t["k1m_group10_bound"] = bound(2 * px * t["k1m_group10_launches"],
                                   10 * 2 * (7 - 1) * px * t["k1m_near_share_30"])
    t["k1m_reach120_bound"] = bound(2 * px * t["k1_split_reach120_k1m_launches"],
                                    40 * 2 * (7 - 1) * px * t["k1m_near_share_30"])
    t["k5_bound_ms"] = bounds["track_scan"][0]
    # K2 on density 0.3, given its occupancy: every strip occupied
    t["k2_dense_occ_bound_ms"] = bound(strip_occ.numel() + int(dense_occ.sum()) * STRIP_PX,
                                       CCL_OPS_PER_PX * int(dense_occ.sum()) * STRIP_PX)[0]
    # K6 as the route calls it (no bbox, no labels), given K3's occupancy:
    # the occupancy read, the occupied strips' int32 labels read, the
    # count and sums written (the work of this run's data); deriving it:
    # every label read once; with the dense ids: their int32 write besides
    k6_out = N * 4 + N * MAX_COMPONENTS * 3 * 8
    bounds["root_stats"] = bound(root_occ.numel() + 4 * root_occupied_px + k6_out,
                                 CCL_OPS_PER_PX * root_occupied_px)
    t["k6_deriving_bound"] = bound(4 * px + k6_out, CCL_OPS_PER_PX * px)
    t["k6_labels_occ_bound"] = bound(root_occ.numel() + 4 * root_occupied_px + k6_out + 4 * px,
                                     CCL_OPS_PER_PX * root_occupied_px)
    say("timing", card=card, batch=N, shape=[1080, 1920], kernels_bit_equal_at_batch_256=True, **t)
    # staging per batch (Python feeder, native feeder, pageable copy) and
    # the routes' frames/s with each feeder, in turns
    say("staging", **staging_timing(clip, plate, card, cfg))

    # 9. the micro-probes
    probe_entries = probes_phase(card)

    timed = {"fused_segment": ("k1_ms", "k1_plain_ms"), "ccl_stats": ("k2_ms", "k2_plain_ms"),
             "fused_segment_padded_occ": ("k1_padded_occ_ms", "k1_padded_occ_plain_ms"),
             "ccl_stats_occ": ("k2_occ_ms", "k2_plain_ms"),
             "ccl_labels": ("k3_ms", "k3_plain_ms"),
             "ccl_labels_conn4": ("k3_conn4_ms", "k3_conn4_plain_ms"),
             "root_stats": ("k6_occ_ms", "k6_plain_ms"),
             "fused_segment_diff": ("k1_diff_ms", "k1_diff_plain_ms"),
             "histogram_u8": ("k4_ms", "k4_plain_ms"),
             "track_scan": ("k5_ms", "k5_plain_ms"),
             "blur_u8": ("k1b_65_ms", "k1b_plain_ms"),
             "morph_u8": ("k1m_rect7_dilate_ms", "k1m_plain_ms"),
             "median_u8": (f"k7_{MEDIAN_K_TIMED[0]}_ms", f"k7_{MEDIAN_K_TIMED[0]}_plain_ms"),
             # the histogram tier at k = 11 on 64 frames, torch.median's frames
             "median_u8_hist": ("k7_11_64_ms", "k7_11_64_plain_ms")}
    launches = {
                # the streamed default route's K1 (the staged route's is padded)
                "fused_segment": default_counts["fused_segment"],
                "fused_segment_padded_occ": staged_counts["fused_segment_padded_occ"],
                # K2 deriving the occupancy: the staged Otsu route
                "ccl_stats": otsu_staged_counts["ccl_stats"] - otsu_staged_counts["ccl_stats_occ"],
                "ccl_stats_occ": staged_counts["ccl_stats_occ"],
                "ccl_labels": default_counts["ccl_labels"],
                # K3 4-connected: no route; connected_components_with_stats(
                # connectivity=4), the ops API, in phase 5
                "ccl_labels_conn4": conn4_counts["ccl_labels_conn4"],
                # K6 given K3's occupancy: the streamed default route
                "root_stats": default_counts["root_stats_occ"],
                # the staged Otsu run launches K1 only with emit="diff"
                "fused_segment_diff": otsu_staged_counts["fused_segment"],
                "histogram_u8": otsu_staged_counts["histogram_u8"],
                "track_scan": staged_counts["track_scan"],
                # the configs one K1 launch does not take (phase 5c)
                "blur_u8": split_launches["blur_u8"],
                "morph_u8": split_launches["morph_u8"],
                # the median routes at 1080p (phase 7g, process_clip): the
                # networks at median 5, the histogram tier at 15
                "median_u8": med_runs["median5"]["runs"]["process_clip"]["launches"]["median_u8"],
                "median_u8_hist":
                    med_runs["median15"]["runs"]["process_clip"]["launches"]["median_u8"]}
    library = {"histogram_u8": t["k4_library_ms"], "morph_u8": t["k1m_library_ms"],
               "median_u8": t[f"k7_{MEDIAN_K_TIMED[0]}_library_ms"],
               "median_u8_hist": t["k7_11_64_library_ms"]}
    bounds["median_u8"] = t[f"k7_{MEDIAN_K_TIMED[0]}_bound"]
    bounds["median_u8_hist"] = t["k7_11_64_bound"]
    # the multistream phase's K1 and K5 (S streams a launch)
    for name, (ms, plain) in ms_kernels["times"].items():
        t[f"{name}_ms"], t[f"{name}_plain_ms"] = ms, plain
        timed[name] = (f"{name}_ms", f"{name}_plain_ms")
    launches.update(ms_kernels["launches"])
    bounds.update(ms_kernels["bounds"])
    # phase 7e's KM, KW, KR, KE, KG and KS's sequential order; 7j's KS;
    # 7f's KB
    for name, k in dict(filter_kernels, background_scan=ks_kernel, **kb_kernels).items():
        t[f"{name}_ms"], t[f"{name}_plain_ms"] = k["ms"], k["plain_ms"]
        timed[name] = (f"{name}_ms", f"{name}_plain_ms")
        launches[name] = k["launches"]
        bounds[name] = (k["bound_ms"], k["bound_by"])
        library[name] = k["library_ms"]
    kernels = []
    for name, (src, rep) in REPLACES.items():
        if name in probe_entries:
            kernels.append(dict(probe_entries[name], stream_axis=False))
            continue
        ms, plain = timed[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches[name], "max_abs_err": err[name],
                        "ms": t[ms], "plain_ms": t[plain], "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1], "library_ms": library.get(name),
                        "stream_axis": name in STREAM_AXIS, **K7_AT.get(name, {})})
    say("done", seconds=round(time.time() - t_all, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
