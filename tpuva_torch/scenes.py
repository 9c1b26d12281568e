"""Synthetic inputs that the kernel tests and ``chip_smoke.py`` hold the
kernels against their plain versions on; numpy only:

- (H, W) and (N, H, W) uint8 masks (0/255) that exercise the CCL
  kernels' tile borders, ragged edges, occupancy skips (``edge_strip_scene``
  8- and 4-connected, ``conn4_scene``) and component caps;
- detection streams for the tracker (``det_sequence``): churn, empty
  frames, contested frames (the Hungarian search's slow path), more
  detections than free slots, and random clouds;
- configs that one launch of kernel K1 does not take (``k1_refused_config``);
- the chip checks of tpuva's ``bench/tpu_smoke.py`` and BASELINE configs
  1-3 (``baseline_case``): each case's clip recipe, config and whether
  the staged route takes the padded handoff at the clip's size;
- kernel K6's options (``ROOT_STATS_OPTIONS``);
- uint8 frames that stress an exact median's ties and orders
  (``median_adversarial``, kernel K7);
- uint8 masks for the exact distance transform (``edt_scenes``, kernel
  KE): densities 0.01 to 0.9, zero-free columns and rows, no zero and no
  foreground, 1-px lines, a lone corner zero, odd shapes, leading axes;
- frames for the band path's CCL (kernels KB): a serpentine that crosses
  every band several times (``serpentine_clip``: many reconciliation
  rounds) and a band with more pieces than its table holds, duplicates
  among its largest (``piece_overflow_clip``).
"""

import dataclasses
from typing import NamedTuple

import numpy as np


def u_shape(H, W):
    """One component running right, down and back left across tiles."""
    m = np.zeros((H, W), np.uint8)
    m[10:14, 20:W - 10] = 255
    m[10:H - 10, W - 20:W - 10] = 255
    m[H - 20:H - 10, 30:W - 10] = 255
    return m


def mixed_scene():
    """One batch, one shape: random, empty, tile-straddling blobs, a U
    across tiles, and more components than C."""
    rng = np.random.default_rng(3)
    H, W = 130, 280
    m = np.zeros((5, H, W), np.uint8)
    m[0] = (rng.random((H, W)) < 0.25) * 255
    m[2, 60:70, 250:265] = 255  # crosses a 256-column border
    m[2, 62:66, 10:30] = 255
    m[2, 126:130, 0:8] = 255  # image edge, unaligned H
    m[2, 63:65, 120:200] = 255  # crosses a 64-row border
    m[3] = u_shape(H, W)
    m[4, 5:H:6, 5:W:7] = 255  # 21 x 40 isolated dots
    return m


def edge_strip_scene(H=71, W=601):
    """One batch for the strip-occupancy skip of K3 and K6 (strips of 2
    rows x 256 columns; tiles of 32 x 64 pixels): odd H and W, so the last
    strip row holds one pixel row and the last strip column is ragged.
    Frames: one pixel in the last strip of the last strip row; one
    occupied strip at the right edge; one at the bottom edge; a diagonal
    and a ring that cross tile and strip borders (8-connected only across
    a strip's corner); every pixel; none; a random mask of density 0.3."""
    rng = np.random.default_rng(9)
    m = np.zeros((7, H, W), np.uint8)
    m[0, H - 1, W - 1] = 255
    m[1, 3:H - 3:2, W - 40:W - 2] = 255  # one strip column, rows apart
    m[2, H - 1, 100:230] = 255  # the last strip row, one pixel row high
    m[2, H - 2, 200:240:3] = 255
    for k in range(min(H, W - 300)):  # a diagonal across strips 0-2
        m[3, k, 220 + k] = 255
    m[3, 30:34, 250:262] = 255  # a ring over a tile and a strip border
    m[3, 30:46, 250] = m[3, 30:46, 261] = 255
    m[3, 42:46, 250:262] = 255
    m[3, 31, 255] = m[3, 32, 256] = 0  # a 4-connected break, 8-linked
    m[3, 63, 511] = m[3, 64, 512] = 255  # touching only at a strip corner
    m[4] = 255
    m[6] = (rng.random((H, W)) < 0.3) * 255
    return m


def conn4_scene(H=45, W=601):
    """One batch for K3 4-connected's occupancy skip (strips of one row x
    512 pixels, segments of 32; tiles of 16 x 32 pixels). H = 45 and
    W = 601 by default: H % 16 != 0, W % 4 != 0, a ragged last strip.
    Frames: a snake crossing tile rows, tile columns and the 512-column
    strip border, whose minimum pixel is reached only backwards; two
    components touching only diagonally across a tile corner next to
    empty tiles (and across the strip border's corner), plus a pixel in
    the last row and column; empty; every pixel; a random mask of density
    0.3; a comb of vertical teeth joined along the bottom row across
    tiles; diagonal dots (every pair 8-adjacent, none 4-adjacent) over
    the strip border."""
    m = np.zeros((7, H, W), np.uint8)
    m[0, 30:34, 470:560] = 255  # along a tile row, over the strip border
    m[0, 3:34, 556:560] = 255  # up the right end, across tile rows
    m[0, 3:6, 500:560] = 255  # back left along the top
    m[0, 3:20, 500:503] = 255  # and down: its minimum pixel is reached backwards
    m[0, 8, 20:40] = 255  # a separate bar across a tile column
    m[1, 10:16, 20:32] = 255  # ends at the corner (15, 31) of tile (0, 0)
    m[1, 16:22, 32:44] = 255  # starts at (16, 32): tile (1, 1), a diagonal away
    m[1, 31, 511] = m[1, 32, 512] = 255  # a diagonal across the strip corner
    m[1, H - 1, W - 1] = 255
    m[3] = 255
    m[4] = (np.random.default_rng(13).random((H, W)) < 0.3) * 255
    m[5, 2:H - 1, 5:200:9] = 255  # teeth
    m[5, H - 1, 5:200] = 255  # joined along the last row
    for k in range(min(H, 40)):
        m[6, k, 490 + k] = 255
    return m


# kernel K6's options (sums, bbox, labels): the stats alone, with the bbox,
# with the dense ids, with both, and the ids alone (relabel_dense)
ROOT_STATS_OPTIONS = ((True, False, False), (True, True, False), (True, False, True),
                      (True, True, True), (False, False, True))

DET_KINDS = ("churn", "empty", "contested", "crowd", "cloud")


def det_sequence(kind, D, frames=60, seed=0):
    """(dets (F, D, 3) float32 of (x, y, area), valid (F, D) bool), the
    valid detections first in each frame, as extract_detections packs them:
    - churn: objects born and removed at random, moving, with dropouts
      longer than a death patience of 3;
    - empty: two objects seen every third frame only;
    - contested: 3 to 5 detections within 4 px of one point, so columns
      share their nearest track;
    - crowd: D persistent objects, one of them replaced most frames, so
      births outrun a small table's free slots;
    - cloud: D detections at new random points of a 200 px square every
      frame."""
    rng = np.random.default_rng(seed)
    dets = np.zeros((frames, D, 3), np.float32)
    valid = np.zeros((frames, D), bool)
    objs = {}
    nxt = 0
    for t in range(frames):
        if kind == "churn":
            if rng.random() < 0.3 and len(objs) < D + 2:
                objs[nxt] = rng.uniform(20, 200, 2)
                nxt += 1
            if rng.random() < 0.2 and objs:
                del objs[list(objs)[rng.integers(len(objs))]]
            if t % 11 in (5, 6, 7, 8):  # dropouts longer than the patience
                continue
        elif kind == "empty":
            if t % 3:
                continue
            objs = {0: np.array([50.0 + t, 60.0]), 1: np.array([150.0, 30.0 + t])}
        elif kind == "contested":
            base = np.array([100.0, 100.0])
            objs = {k: base + rng.uniform(-4, 4, 2) for k in range(min(D, 3 + t % 3))}
        elif kind == "crowd":
            objs = {k: objs[k] + rng.uniform(-3, 3, 2) if k in objs else rng.uniform(20, 400, 2)
                    for k in range(D)}
            if rng.random() < 0.7:
                objs[int(rng.integers(D))] = rng.uniform(20, 400, 2)
        elif kind == "cloud":
            objs = {k: rng.uniform(100, 300, 2) for k in range(D)}
        else:
            raise ValueError(f"unknown detection stream {kind!r}")
        k = 0
        for key in sorted(objs):
            if kind == "churn":
                objs[key] = objs[key] + rng.uniform(-6, 6, 2)
            if k < D:
                dets[t, k] = (objs[key][0], objs[key][1], rng.integers(30, 90))
                valid[t, k] = True
                k += 1
    return dets, valid


K1_REFUSED = ("open_close_7x10", "median3_5x10", "se33", "blur65", "median5", "median7_otsu")


def k1_refused_config(cfg, name, config=None):
    """cfg (a PipelineConfig of the config module `config`, the port's by
    default) changed so that one launch of kernel K1 does not take it
    (k1_takes): open and close 7 x 10 (morphology reach 120), median 3 with
    open and close 5 x 10 (reach 80), a 33-wide close, a 65-tap blur (the
    first four: fused_segment splits them, k1_split), median 5, median 7
    with Otsu (tpuva's jnp branch), or median 15 (the median route with
    K7's histogram tier; not in K1_REFUSED)."""
    if config is None:
        from tpuva_torch.graph import config
    M = config.MorphConfig
    replace = dataclasses.replace
    return {
        "open_close_7x10": lambda: replace(
            cfg, morph_open=M(ksize=7, iterations=10), morph_close=M(ksize=7, iterations=10)),
        "median3_5x10": lambda: replace(
            cfg, median=config.MedianConfig(3), morph_open=M(ksize=5, iterations=10),
            morph_close=M(ksize=5, iterations=10)),
        "se33": lambda: replace(cfg, morph_close=M(ksize=33)),
        "blur65": lambda: replace(cfg, blur=config.BlurConfig(ksize=65)),
        "median5": lambda: replace(cfg, median=config.MedianConfig(5)),
        "median15": lambda: replace(cfg, median=config.MedianConfig(15)),
        "median7_otsu": lambda: replace(
            cfg, median=config.MedianConfig(7),
            segment=replace(cfg.segment, threshold="otsu")),
    }[name]()


BASELINE_CASES = ("config1_480p", "config2_720p", "config3_births", "otsu_480p", "uhd_4k")


class BaselineCase(NamedTuple):
    name: str
    clip: str  # the refimpl.synthetic generator that makes the clip
    clip_kw: dict  # its arguments (h, w, frames, ...)
    cfg: object  # PipelineConfig, batch included
    padded: bool  # padded_handoff(cfg, h, w): K1's padded mask goes to K2


def baseline_case(name, config=None, **clip_kw):
    """The case `name` of BASELINE_CASES: tpuva's chip checks
    (bench/tpu_smoke.py's config 1, config 2, Otsu at 480p and 4K UHD) and
    BASELINE config 3's births and deaths, at the size the card runs them.
    Keyword arguments replace the clip's (h, w, frames, ...) for a smaller
    run; `config` is the config module (the port's by default). The clip
    starts from its plate (background0), as every pinned route does."""
    if config is None:
        from tpuva_torch.graph import config
    from tpuva_torch.graph.pipeline import padded_handoff

    C = config
    greedy = C.TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8)
    bench = C.PipelineConfig(
        background=C.BackgroundConfig(alpha=0.02), blur=C.BlurConfig(ksize=5, sigma=0.0),
        morph_open=C.MorphConfig(ksize=3, shape="rect"),
        morph_close=C.MorphConfig(ksize=3, shape="ellipse"),
        segment=C.SegmentConfig(threshold=35.0, min_area=50, max_blobs=8),
        track=C.TrackConfig(max_dist=80.0, death_patience=5, max_tracks=16,
                            assigner="hungarian"),
        batch=256)
    blobs = dict(births_deaths=False, noise_sigma=2.0)
    clip, kw, cfg = {
        # 640 x 480, threshold only, greedy: one K1 launch with no blur
        # and no morphology; 300 frames leave a ragged batch of 44
        "config1_480p": ("moving_disk_clip", dict(h=480, w=640, frames=300, noise_sigma=2.0),
                         C.PipelineConfig(
                             background=C.BackgroundConfig(alpha=0.05),
                             segment=C.SegmentConfig(threshold=40.0, min_area=30, max_blobs=4),
                             track=greedy, batch=128)),
        # 720p, blur 5 + median 3 + open 3 rect + close 3 ellipse, Hungarian
        "config2_720p": ("moving_disk_clip",
                         dict(h=720, w=1280, frames=512, radius=24.0, noise_sigma=2.0),
                         C.PipelineConfig(
                             background=C.BackgroundConfig(alpha=0.05),
                             blur=C.BlurConfig(ksize=5, sigma=0.0),
                             median=C.MedianConfig(ksize=3),
                             morph_open=C.MorphConfig(ksize=3, shape="rect"),
                             morph_close=C.MorphConfig(ksize=3, shape="ellipse"),
                             segment=C.SegmentConfig(threshold=35.0, min_area=40, max_blobs=4),
                             track=dataclasses.replace(greedy, assigner="hungarian"),
                             batch=256)),
        # BASELINE config 3: the bench config on blobs that are born and die
        "config3_births": ("multi_blob_clip",
                           dict(h=1080, w=1920, frames=512, n_blobs=8, radius=16.0,
                                births_deaths=True, noise_sigma=2.0),
                           bench),
        # 480p, blur 5 + Otsu, greedy
        "otsu_480p": ("multi_blob_clip",
                      dict(h=480, w=640, frames=256, n_blobs=3, radius=12.0, **blobs),
                      C.PipelineConfig(
                          background=C.BackgroundConfig(alpha=0.05),
                          blur=C.BlurConfig(ksize=5, sigma=0.0),
                          segment=C.SegmentConfig(threshold="otsu", min_area=30, max_blobs=4),
                          track=greedy, batch=128)),
        # 4K UHD, the bench config at batch 64 (531 MB a batch, as at 1080p)
        "uhd_4k": ("multi_blob_clip",
                   dict(h=2160, w=3840, frames=128, n_blobs=6, radius=32.0, **blobs),
                   dataclasses.replace(bench, batch=64)),
    }[name]
    kw = dict(kw, **clip_kw)
    return BaselineCase(name, clip, kw, cfg, padded_handoff(cfg, kw["h"], kw["w"]))


def baseline_clip(case, synthetic):
    """(clip (T, H, W) uint8, plate (H, W) uint8) of a BaselineCase, made
    by `synthetic` (the refimpl.synthetic module)."""
    out = getattr(synthetic, case.clip)(**case.clip_kw)
    return out[0], out[-1]


MEDIAN_ADVERSARIAL = ("constant", "two_values", "zero_255", "ramp_x", "ramp_y_down", "ramp_xy",
                      "outliers")


def median_adversarial(shape, seed=0):
    """{name: (N, H, W) uint8 frames} for each of MEDIAN_ADVERSARIAL:
    constant, two values, 0 and 255 only, a rising ramp along the rows, a
    falling one down the columns, a diagonal one, and isolated outliers
    (255 and 0) in a constant frame."""
    N, H, W = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    outliers = np.full((H, W), 100, np.uint8)
    outliers[3::7, 2::9] = 255
    outliers[6::11, 5::13] = 0
    frames = {
        "constant": np.full((H, W), 77, np.uint8),
        "two_values": rng.choice(np.array([10, 200], np.uint8), (H, W)),
        "zero_255": rng.choice(np.array([0, 255], np.uint8), (H, W)),
        "ramp_x": (xx % 256).astype(np.uint8),
        "ramp_y_down": (255 - yy % 256).astype(np.uint8),
        "ramp_xy": ((xx + 3 * yy) % 256).astype(np.uint8),
        "outliers": outliers,
    }
    return {name: np.broadcast_to(frames[name], shape).copy() for name in MEDIAN_ADVERSARIAL}


def edt_scenes():
    """{name: uint8 mask (..., H, W)} of the distance transform's checks,
    from one seed (nonzero = foreground)."""
    rng = np.random.default_rng(20)
    scenes = {f"density_{d}": (rng.random((2, 37, 53)) < d).astype(np.uint8)
              for d in (0.01, 0.05, 0.2, 0.5, 0.7, 0.9)}
    m = (rng.random((37, 53)) < 0.3).astype(np.uint8)
    m[:, 10:30] = 1  # columns with no zero
    m[5:9, :] = 1  # rows with no zero (but zeros in their columns)
    scenes["zero_free_columns_and_rows"] = m
    scenes["all_foreground"] = np.ones((2, 19, 23), np.uint8)
    scenes["all_background"] = np.zeros((2, 19, 23), np.uint8)
    line = np.ones((3, 31, 41), np.uint8)
    line[0, 15, :] = 0  # a row of zeros
    line[1, :, 20] = 0  # a column of zeros
    line[2, 0, 40] = 0  # one zero in a corner
    scenes["lines_and_a_corner"] = line
    scenes["odd_37x301"] = (rng.random((37, 301)) < 0.93).astype(np.uint8)
    scenes["leading_axes"] = (rng.random((2, 3, 17, 29)) < 0.8).astype(np.uint8)
    scenes["one_row"] = np.array([[1, 1, 0, 1, 1, 1, 1]], np.uint8)
    scenes["one_column"] = np.array([[1], [0], [1], [1]], np.uint8)
    return scenes


def edt_large_scenes():
    """{name: uint8 mask (..., H, W)} of the distance transform's size
    checks on the card, from one seed: the single-zero masks whose float32
    sums round (4096 x 94 and 2898 x 2898, the zero at (0, 0)), a 5000 x 3
    mask with one zero at (0, 1) (column distances past 4096: the rounded
    f table), an 8K UHD motion-like mask (discs of foreground on
    background), 3-row masks at the widest row KE keeps in shared memory
    (25,600: zeros on its first row's ends and on its last row but for an
    8400-px span, whose middle lies past 4096 px from every zero, so the
    row loop runs there in shared memory) and past it (28,672: zeros all
    along its last row), a 1 x 70,000 row with zeros only at its ends (sums
    past 2^24), and 65,536 masks of 5 x 7 (more than one launch takes)."""
    rng = np.random.default_rng(21)
    scenes = {}
    for H, W in ((4096, 94), (2898, 2898)):
        m = np.ones((H, W), np.uint8)
        m[0, 0] = 0
        scenes[f"single_zero_{H}x{W}"] = m
    m = np.ones((5000, 3), np.uint8)
    m[0, 1] = 0
    scenes["tall_5000x3"] = m
    H, W = 4320, 7680
    m = np.zeros((H, W), np.uint8)
    for _ in range(60):
        cy, cx, r = rng.integers(0, H), rng.integers(0, W), int(rng.integers(8, 240))
        y0, y1, x0, x1 = max(cy - r, 0), min(cy + r + 1, H), max(cx - r, 0), min(cx + r + 1, W)
        yy, xx = np.ogrid[y0:y1, x0:x1]
        m[y0:y1, x0:x1] |= ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)
    m[rng.random((H, W)) < 0.002] = 1  # speckle
    scenes["motion_4320x7680"] = m
    for W, span in ((25600, 8400), (28672, 0)):
        m = np.ones((3, W), np.uint8)
        m[0, 0] = m[0, -1] = 0
        m[2, :W - span] = rng.random(W - span) < 0.9
        scenes[f"rows_3x{W}"] = m
    row = np.ones((1, 70000), np.uint8)
    row[0, 0] = row[0, -1] = 0
    scenes["row_1x70000"] = row
    scenes["masks_65536x5x7"] = (rng.random((65536, 5, 7)) < 0.7).astype(np.uint8)
    return scenes


def serpentine_clip(H=96, W=128, T=8, level=200):
    """(T, H, W) uint8: one line, 2 px wide, down and up the frame through
    columns 16 apart, joined alternately at the bottom and at the top, with
    a disk beside it; frame t shifted t px right. On 4 bands its minimum
    key (top left) reaches the last column's pieces one band a
    reconciliation round: 22 rounds."""
    clip = np.zeros((T, H, W), np.uint8)
    yy, xx = np.mgrid[:H, :W]
    for t in range(T):
        f = clip[t]
        cols = [8 + t + 16 * k for k in range(7) if 8 + t + 16 * k + 1 < W - 8]
        for c in cols:
            f[2:H - 2, c:c + 2] = level
        for k in range(len(cols) - 1):
            r = slice(H - 4, H - 2) if k % 2 == 0 else slice(2, 4)
            f[r, cols[k]:cols[k + 1] + 2] = level
        f[(yy - H // 2) ** 2 + (xx - (W - 5 - t % 3)) ** 2 <= 9] = level
    return clip


def piece_overflow_clip(H=96, W=128, T=8, level=200):
    """(T, H, W) uint8 for 4 bands and 32 components a frame: a comb whose
    bar lies in band 0 and whose 10 teeth reach into band 1, 30 one-pixel
    specks lower in band 1, and a disk moving through bands 2 and 3. Band
    1 holds 40 pieces: its top 32 values are the 30 specks' and two of the
    teeth's one value (duplicates), so its table holds 31 entries and 8
    pieces overflow it (none of the comb's pixels is lost: its value is in
    the table)."""
    Hb = H // 4
    clip = np.zeros((T, H, W), np.uint8)
    yy, xx = np.mgrid[:H, :W]
    for t in range(T):
        f = clip[t]
        f[Hb - 6:Hb - 2, 8:W - 8] = level
        for k in range(10):
            f[Hb - 2:Hb + 10, 8 + 12 * k:10 + 12 * k] = level
        for r in (Hb + 14, Hb + 18, Hb + 22):
            f[r, 6:6 + 12 * 10:12] = level
        f[(yy - (2 * Hb + 12 + t)) ** 2 + (xx - (20 + 6 * t)) ** 2 <= 36] = level
    return clip
