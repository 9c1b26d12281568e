"""The port's spatial processor (tpuva_torch.dist.spatial: one stream banded
by rows over a mesh of devices, here 2, 3 and 4 bands on the CPU) against
the port's single-device process_batch and tpuva's make_spatial_processor
on the simulated CPU mesh (tests/conftest.py gives JAX 8 devices).

Against the port's process_batch every output, the carried background and
the track table are bit-equal: the band front end is K1's plain version on
each band's rows plus an interior halo, the band CCL and merge give the
single-device stats. Against tpuva the rows, sums, stats_overflow and
tp_recon_rounds are equal and the background within rtol 1e-5 (XLA:CPU
FMA-contracts tpuva's update, ROADMAP Queue 3, R1). The scenes are tpuva's
three (tests/test_spatial_tp.py), an odd band height (H = 90 on 2
bands: a 2 x 2 block of the global scan keys straddles the bands), a
serpentine through all four bands that takes 22 reconciliation
rounds (tpuva's Jacobi order: a band reads its neighbours' edges from
before the round) and a band with more pieces than its table, duplicates
among its largest values (stats_overflow > 0, the table shorter than C);
each tpuva program runs once a module, through the `tpuva_runs` fixture.

The band CCL's plain versions (ops.band_ccl: KB-labels, KB-recon,
KB-table) are held to transcriptions of tpuva's stages on tpuva's own
helpers: band_sweep's fixed point at even and odd first rows, the
reconciliation round by round, the table and its limb sums.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import tpuva.dist.spatial as jsp
import tpuva.graph.config as jcfg
import tpuva.graph.pipeline as jpl
from refimpl.synthetic import moving_disk_clip
from jax import lax
from tpuva.ops.label import _neighbor_min_8 as j_neighbor_min_8
from tpuva.ops.label import _scan_key as j_scan_key
from tpuva.ops.label import _segmented_min_scan as j_segmented_min_scan
from tpuva_torch.dist.spatial import _halo_rows, make_space_mesh, make_spatial_processor
from tpuva_torch.graph import config as tcfg
from tpuva_torch.graph.pipeline import _front_end_emit, init_carry, process_batch, torch_front_end
from tpuva_torch.ops import band_ccl
from tpuva_torch.ops.label import _segmented_min_scan
from tpuva_torch.scenes import piece_overflow_clip, serpentine_clip
from tpuva_torch.track.table import TrackState
from test_torch_kernels import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
OUT_KEYS = ("rows", "row_valid", "row_sums", "n_det", "active_tracks", "stats_overflow")


def cfg(module, kind):
    """tpuva's test configs: "fixed" and "otsu" (tests/test_spatial_tp.py:20,
    :112), "bare" the adversarial scene's (no filter, alpha 0)."""
    if kind == "bare":
        return module.PipelineConfig(
            background=module.BackgroundConfig(alpha=0.0),
            segment=module.SegmentConfig(threshold=40.0, min_area=2, max_blobs=8),
            track=module.TrackConfig(max_dist=80.0, death_patience=3, max_tracks=16),
            batch=4,
        )
    otsu = kind == "otsu"
    return module.PipelineConfig(
        background=module.BackgroundConfig(alpha=0.05),
        blur=module.BlurConfig(ksize=5, sigma=0.0),
        morph_open=module.MorphConfig(ksize=3, shape="rect"),
        morph_close=None if otsu else module.MorphConfig(ksize=3, shape="ellipse"),
        segment=module.SegmentConfig(threshold="otsu" if otsu else 35.0, min_area=20,
                                     max_blobs=4),
        track=module.TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=8,
    )


def adversarial_clip():
    """tpuva's band-spanning scene (tests/test_spatial_tp.py:62): a U whose
    arms are separate pieces inside the middle bands, a line through every
    band, speckle noise."""
    H, W, T = 96, 128, 8
    rng = np.random.default_rng(20)
    clip = np.zeros((T, H, W), np.uint8)
    clip[:, 10:80, 20:24] = 200
    clip[:, 10:80, 40:44] = 200
    clip[:, 10:14, 20:44] = 200
    clip[:, 0:96, 100:102] = 200
    noise = (rng.random((T, H, W)) > 0.995).astype(np.uint8) * 200
    return np.maximum(clip, noise), np.zeros((H, W), np.float32)


def disk_clip(H, W, T, seed):
    clip, _truth, plate = moving_disk_clip(h=H, w=W, frames=T, radius=9, noise_sigma=3.0,
                                           seed=seed)
    return clip, plate.astype(np.float32)


def bare_clip(make):
    """A scene's frames with the zero plate of the "bare" config."""
    clip = make()
    return clip, np.zeros(clip.shape[1:], np.float32)


# name: (config kind, bands, max_components, clip)
SCENES = {
    "disk_4": ("fixed", 4, 64, lambda: disk_clip(128, 160, 24, 6)),
    "adversarial_4": ("bare", 4, 32, adversarial_clip),
    "otsu_4": ("otsu", 4, 64, lambda: disk_clip(128, 160, 16, 13)),
    "disk_3": ("fixed", 3, 64, lambda: disk_clip(96, 128, 16, 4)),
    "odd_2": ("fixed", 2, 64, lambda: disk_clip(90, 96, 16, 2)),
    "serpentine_4": ("bare", 4, 32, lambda: bare_clip(serpentine_clip)),
    "overflow_4": ("bare", 4, 32, lambda: bare_clip(piece_overflow_clip)),
}


def run_tpuva(kind, n, C, clip, plate):
    c = cfg(jcfg, kind)
    T, H, W = clip.shape
    fn = jsp.make_spatial_processor(c, H, W, n, mesh=jsp.make_space_mesh(n), max_components=C)
    carry = jpl.init_carry(c, H, W, plate)
    outs = []
    for s in range(0, T, c.batch):
        carry, out = fn(carry, jnp.asarray(clip[s:s + c.batch]))
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return carry, outs


@pytest.fixture(scope="module")
def tpuva_runs():
    """Every scene through tpuva's spatial processor, once a module."""
    return {name: (clip_plate, run_tpuva(kind, n, C, *clip_plate))
            for name, (kind, n, C, make) in SCENES.items()
            for clip_plate in [make()]}


def run_port(kind, n, C, clip, plate, bands_in=False):
    """The scene through the port's spatial processor and its single-device
    process_batch; returns (spatial carry, spatial outs, single carry,
    single outs)."""
    c = cfg(tcfg, kind)
    T, H, W = clip.shape
    fn = make_spatial_processor(c, H, W, n, mesh=make_space_mesh(n, [CPU] * n), max_components=C)
    carry_sp = init_carry(c, H, W, plate, device="cpu")
    carry_1 = init_carry(c, H, W, plate, device="cpu")
    outs_sp, outs_1 = [], []
    for s in range(0, T, c.batch):
        chunk = torch.from_numpy(clip[s:s + c.batch])
        frames = chunk.chunk(n, dim=1) if bands_in else chunk
        carry_sp, out = fn(carry_sp, frames)
        outs_sp.append(out)
        carry_1, out_1 = process_batch(c, carry_1, chunk, max_components=C)
        outs_1.append(out_1)
    return carry_sp, outs_sp, carry_1, outs_1


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_spatial_matches_single_device_and_tpuva(scene, tpuva_runs):
    """Every batch's outputs bit-equal to the port's process_batch, the
    carried background, track table and frame index too; rows, sums,
    stats_overflow and tp_recon_rounds equal to tpuva's spatial processor,
    the background within R1's rtol."""
    kind, n, C, _make = SCENES[scene]
    (clip, plate), (carry_j, outs_j) = tpuva_runs[scene]
    kb = ("band_labels", "recon_edges", "recon_min", "piece_table", "piece_sums")
    before = {name: getattr(band_ccl, name).launches for name in kb}
    carry_sp, outs_sp, carry_1, outs_1 = run_port(kind, n, C, clip, plate,
                                                  bands_in=scene == "disk_3")
    assert {name: getattr(band_ccl, name).launches for name in kb} == before, \
        "KB launched on the CPU"
    for step, (o, o1, oj) in enumerate(zip(outs_sp, outs_1, outs_j)):
        for k in OUT_KEYS:
            if k == "stats_overflow" and scene == "overflow_4":
                continue  # a band's table overflows; one device has no band tables
            assert torch.equal(o[k], o1[k]), f"step {step}: {k} against process_batch"
        for k in ("rows", "row_valid", "row_sums", "stats_overflow", "tp_recon_rounds"):
            np.testing.assert_array_equal(o[k].numpy(), oj[k], err_msg=f"step {step}: {k}")
    assert sum(int(o["row_valid"].sum()) for o in outs_sp), "no detections: the scene is vacuous"
    assert isinstance(carry_sp.bg, tuple) and len(carry_sp.bg) == n
    bg = torch.cat(carry_sp.bg)
    assert torch.equal(bg, carry_1.bg)
    for f in TrackState._fields:
        assert torch.equal(getattr(carry_sp.track, f), getattr(carry_1.track, f)), f
        np.testing.assert_array_equal(getattr(carry_sp.track, f).numpy(),
                                      np.asarray(getattr(carry_j.track, f)), err_msg=f)
    assert int(carry_sp.frame_idx) == int(carry_1.frame_idx) == int(carry_j.frame_idx)
    np.testing.assert_allclose(bg.numpy(), np.asarray(carry_j.bg), rtol=1e-5)
    if scene == "adversarial_4":  # components through 2-4 bands take > 1 round
        assert all(int(o["tp_recon_rounds"]) > 1 for o in outs_sp)
        assert all(int(o["stats_overflow"].max()) == 0 for o in outs_sp)
    if scene == "serpentine_4":  # the line's minimum crosses a band a round
        assert all(int(o["tp_recon_rounds"]) >= 3 for o in outs_sp)
    if scene == "overflow_4":  # band 1: 40 pieces, a table of 32 slots
        assert all(torch.equal(o["stats_overflow"], torch.full_like(o["stats_overflow"], 8))
                   for o in outs_sp)
        assert all(int(o1["stats_overflow"].max()) == 0 for o1 in outs_1)


@pytest.mark.parametrize("kind,n", [("fixed", 4), ("otsu", 4), ("fixed", 2)])
def test_band_front_end_is_the_single_device_mask(kind, n):
    """Each band's front end — its rows with the halo on its interior sides
    only, K1's plain version bordering the true image edges — gives the
    single-device mask's rows and background rows; for Otsu with the
    thresholds of the whole frames' histogram."""
    c = cfg(tcfg, kind)
    clip, plate = disk_clip(90 if n == 2 else 128, 160, 8, 11)
    T, H, W = clip.shape
    Hb, halo = H // n, _halo_rows(c)
    frames = torch.from_numpy(clip)
    carry = init_carry(c, H, W, plate, device="cpu")
    mask, bg_last = torch_front_end(c, carry, frames)
    if kind == "otsu":
        from tpuva_torch.ops.filters import otsu_threshold

        du8, _bg = _front_end_emit(c, carry, frames)
        thr = otsu_threshold(du8)
    for b in range(n):
        lo, hi = max(0, b * Hb - halo), min(H, (b + 1) * Hb + halo)
        band = carry._replace(bg=carry.bg[lo:hi])
        out, bg_b = _front_end_emit(c, band, frames[:, lo:hi])
        if kind == "otsu":
            from tpuva_torch.graph.pipeline import _otsu_mask

            out = _otsu_mask(c, out, thr)
        rows = slice(b * Hb - lo, b * Hb - lo + Hb)
        assert torch.equal(out[:, rows], mask[:, b * Hb:(b + 1) * Hb]), f"band {b}"
        assert torch.equal(bg_b[rows], bg_last[b * Hb:(b + 1) * Hb]), f"band {b}"


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_segmented_min_scan_matches_tpuva(axis, reverse):
    """tpuva's prefix doubling and the port's cummin over run-keyed int64
    give the same bits on random masks of five densities (3 frames each),
    random int32 values (their extremes included) and odd lengths."""
    rng = np.random.default_rng(10 * axis + reverse)
    densities = np.repeat([0.0, 0.2, 0.5, 0.9, 1.0], 3)[:, None, None]
    m = rng.random((15, 37, 45)) < densities
    v = rng.integers(-2**31, 2**31, m.shape, dtype=np.int64).astype(np.int32)
    v.reshape(-1)[:2] = (-2**31, 2**31 - 1)
    scan = jax.jit(j_segmented_min_scan, static_argnums=(2, 3), static_argnames=("reverse",))
    want = np.asarray(scan(jnp.asarray(v), jnp.asarray(m), axis, 7, reverse=reverse))
    got = _segmented_min_scan(torch.from_numpy(v), torch.from_numpy(m), axis, 7, reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,n,kind,match", [
    (96, 5, "fixed", "not divisible"),  # 96 % 5
    (40, 8, "fixed", "halo larger than band"),  # halo 6 > 5 rows
    (8, 8, "bare", "at least 2 rows"),  # 1-row bands, halo 1
])
def test_bad_geometry_raises_tpuva_errors(H, n, kind, match):
    """tpuva's checks, types and messages, in tpuva's order; a mesh of
    too few devices raises too, and the default mesh (the cards) has none
    here."""
    for module, make in ((jcfg, jsp.make_spatial_processor), (tcfg, make_spatial_processor)):
        mesh = (jsp.make_space_mesh(n) if module is jcfg
                else make_space_mesh(n, [CPU] * n))
        with pytest.raises(ValueError, match=match):
            make(cfg(module, kind), H, 64, n, mesh=mesh)
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_space_mesh(4, [CPU] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            make_space_mesh(2)


# ---- the band CCL's plain versions against tpuva's stages, transcribed
# from tpuva/dist/spatial.py on tpuva's own helpers (:180-310)

def j_band_sweep(l, m, sent, precheck=False):
    """tpuva's band_sweep (:191)."""
    def sweep(label):
        label = jnp.where(m, jnp.minimum(label, j_neighbor_min_8(label, sent)), sent)
        label = j_segmented_min_scan(label, m, 2, sent)
        label = j_segmented_min_scan(label, m, 2, sent, reverse=True)
        label = j_segmented_min_scan(label, m, 1, sent)
        label = j_segmented_min_scan(label, m, 1, sent, reverse=True)
        return label

    def body(s):
        cur, _ = s
        new = sweep(cur)
        return new, jnp.any(new != cur)

    if precheck:
        nb = jnp.where(m, jnp.minimum(l, j_neighbor_min_8(l, sent)), sent)
        ch0 = jnp.any(nb != l)
    else:
        ch0 = jnp.bool_(True)
    l, _ = lax.while_loop(lambda s: s[1], body, (l, ch0))
    return l


j_band_sweep_jit = jax.jit(j_band_sweep, static_argnums=(2, 3))


def j_recon_round(labs, ms, sent):
    """tpuva's recon_body (:229) on every band at once: each band's edges
    against its neighbours' edges from before the round, the band
    re-swept; returns (labels, changed a band)."""
    n = len(labs)

    def adj(nb):
        le = jnp.pad(nb, ((0, 0), (1, 0)), constant_values=sent)[:, :-1]
        ri = jnp.pad(nb, ((0, 0), (0, 1)), constant_values=sent)[:, 1:]
        return jnp.minimum(nb, jnp.minimum(le, ri))

    out, changed = [], []
    for b, (l, m) in enumerate(zip(labs, ms)):
        none = jnp.full_like(l[:, 0], sent)
        from_above = labs[b - 1][:, -1] if b > 0 else none
        from_below = labs[b + 1][:, 0] if b < n - 1 else none
        new_top = jnp.where(m[:, 0], jnp.minimum(l[:, 0], adj(from_above)), jnp.int32(sent))
        new_bot = jnp.where(m[:, -1], jnp.minimum(l[:, -1], adj(from_below)), jnp.int32(sent))
        l2 = jnp.concatenate([new_top[:, None], l[:, 1:-1], new_bot[:, None]], axis=1)
        changed.append(bool(jnp.any(l2 != l)))
        out.append(j_band_sweep_jit(l2, m, sent, True))
    return out, changed


def j_band_start(mask_band, y0, W, sent):
    """tpuva's lab0 and keys of the band (:180-190)."""
    Hb = mask_band.shape[1]
    Wb2 = (W + 1) // 2
    rr = jnp.arange(Hb, dtype=jnp.int32)[:, None] + y0
    cc = jnp.arange(W, dtype=jnp.int32)[None, :]
    kv = ((rr >> 1) * Wb2 + (cc >> 1)) * 4 + (rr & 1) * 2 + (cc & 1)
    m = jnp.asarray(mask_band) > 0
    return jnp.where(m, kv[None], jnp.int32(sent)), m, kv


def port_values(p):
    """The piece form's labels as tpuva's per-pixel labels."""
    fg = p.lab != p.sent
    blk = torch.where(fg, (p.lab - p.kbase) >> 2, 0).long()
    v = p.val.gather(1, blk.reshape(p.lab.shape[0], -1)).reshape(p.lab.shape)
    return torch.where(fg, v, p.sent)


def random_bands(seed, N=3, H=48, W=70, density=0.35):
    return (np.random.default_rng(seed).random((N, H, W)) < density).astype(np.uint8) * 255


@pytest.mark.parametrize("y0", [0, 10, 11, 45], ids=lambda y: f"y0_{y}")
def test_band_labels_plain_is_tpuvas_band_sweep(y0):
    """KB-labels' plain version = tpuva's band_sweep from lab0 on a band
    whose first row y0 is even and odd, with its sentinel background; each
    piece's root block holds its key, nroots the pieces (scipy's count)."""
    from scipy import ndimage

    mask = random_bands(y0)
    N, Hb, W = mask.shape
    H = y0 + Hb + 3
    sent = j_scan_key(H, W, 8)[2]
    l0, m, kv = j_band_start(mask, y0, W, sent)
    want = np.asarray(j_band_sweep(l0, m, sent))
    p = band_ccl.band_labels(torch.from_numpy(mask), 0, Hb, y0, sent)
    np.testing.assert_array_equal(p.lab.numpy(), want)
    np.testing.assert_array_equal(port_values(p).numpy(), want)
    pieces = [ndimage.label(f, np.ones((3, 3)))[1] for f in mask > 0]
    assert p.nroots.tolist() == pieces
    roots = (np.asarray(m) & (want == np.asarray(kv)[None]))
    assert p.nroots.tolist() == roots.reshape(N, -1).sum(1).tolist()


@pytest.mark.parametrize("scene", ["serpentine", "random_odd"])
def test_recon_rounds_plain_are_tpuvas(scene):
    """KB-recon's plain versions, every band's recon_edges then every
    band's recon_min, round by round equal to tpuva's recon_body on every
    band: the labels after each round (the piece values on each pixel) and
    which bands changed, and so the number of rounds."""
    if scene == "serpentine":
        mask, n = serpentine_clip(T=2), 4
    else:
        mask, n = random_bands(7, N=2, H=90, W=64, density=0.5), 6  # bands of 15 rows
    N, H, W = mask.shape
    Hb = H // n
    sent = j_scan_key(H, W, 8)[2]
    labs, ms, pieces = [], [], []
    for b in range(n):
        l0, m, _kv = j_band_start(mask[:, b * Hb:(b + 1) * Hb], b * Hb, W, sent)
        labs.append(j_band_sweep_jit(l0, m, sent, False))
        ms.append(m)
        pieces.append(band_ccl.band_labels(torch.from_numpy(mask), b * Hb, Hb, b * Hb, sent))
    rounds = 0
    while True:
        rounds += 1
        labs, want = j_recon_round(labs, ms, sent)
        edges = [band_ccl.recon_edges(p) for p in pieces]
        got = [bool(band_ccl.recon_min(p, edges[b], edges[b - 1][:, 1] if b > 0 else None,
                                       edges[b + 1][:, 0] if b < n - 1 else None))
               for b, p in enumerate(pieces)]
        assert got == want, f"round {rounds}: changed bands"
        for b in range(n):
            np.testing.assert_array_equal(port_values(pieces[b]).numpy(), np.asarray(labs[b]),
                                          err_msg=f"round {rounds}, band {b}")
        if not any(want):
            break
    assert rounds >= (15 if scene == "serpentine" else 2)


def j_table_sums(lab, lab_local, m, kv, y0, C, sent):
    """tpuva's piece table and its limb sums (:276-312) on one band: (the
    table sorted ascending, its sums (N, C, 3) in that order, n_loc)."""
    N, Hb, W = lab.shape
    root = jnp.where(m, lab + 1, 0)
    is_piece_root = m & (lab_local == kv[None])
    rootv = jnp.where(is_piece_root, lab + 1, 0).reshape(N, Hb * W)
    vals, _idx2 = lax.top_k(rootv, C)
    dup = jnp.concatenate([jnp.zeros((N, 1), bool), vals[:, 1:] == vals[:, :-1]], axis=1)
    n_loc = jnp.sum((rootv > 0).astype(jnp.int32), axis=1)
    table = jnp.where((vals > 0) & ~dup, vals, jnp.int32(sent + 2))
    flat = root.reshape(N, Hb * W)
    eq = (flat[:, :, None] == table[:, None, :]).astype(jnp.bfloat16)
    lin = jax.lax.broadcasted_iota(jnp.int32, (Hb * W, 1), 0)[:, 0]
    x = lin % W
    y = lin // W + y0
    payload = jnp.stack([jnp.ones_like(x), x & 63, (x >> 6) & 63, x >> 12,
                         y & 63, (y >> 6) & 63, y >> 12], axis=-1).astype(jnp.bfloat16)
    sums = np.asarray(jnp.einsum("npc,pk->nck", eq, payload,
                                 preferred_element_type=jnp.float32)).astype(np.int64)
    sums = np.stack([sums[..., 0], sums[..., 1] + 64 * sums[..., 2] + 4096 * sums[..., 3],
                     sums[..., 4] + 64 * sums[..., 5] + 4096 * sums[..., 6]], axis=-1)
    table = np.asarray(table)
    order = np.argsort(table, axis=1, kind="stable")
    return (np.take_along_axis(table, order, 1), np.take_along_axis(sums, order[..., None], 1),
            np.asarray(n_loc))


@pytest.mark.parametrize("case", ["overflow_band_1", "random_odd_C3", "random_C64"])
def test_piece_table_and_sums_plain_are_tpuvas(case):
    """KB-table's plain versions on a band after the reconciliation equal
    tpuva's selection (top_k with multiplicity, adjacent duplicates
    dropped, sent + 2; sorted here as the merge sorts it) and its bf16
    limb sums, entry by entry; nroots is tpuva's n_loc. The overflow band
    holds 40 pieces for 32 slots and its table only 31 entries."""
    if case == "overflow_band_1":
        mask, n, b, C = piece_overflow_clip(T=2), 4, 1, 32
    elif case == "random_odd_C3":
        mask, n, b, C = random_bands(3, N=2, H=90, W=64), 2, 1, 3  # rows 45..89
    else:
        mask, n, b, C = random_bands(4, N=2, H=96, W=80, density=0.3), 3, 1, 64
    N, H, W = mask.shape
    Hb = H // n
    sent = j_scan_key(H, W, 8)[2]
    labs, ms, locs, keys, pieces = [], [], [], [], []
    for k in range(n):
        l0, m, kv = j_band_start(mask[:, k * Hb:(k + 1) * Hb], k * Hb, W, sent)
        locs.append(j_band_sweep_jit(l0, m, sent, False))
        ms.append(m)
        keys.append(kv)
        pieces.append(band_ccl.band_labels(torch.from_numpy(mask), k * Hb, Hb, k * Hb, sent))
    labs = list(locs)
    while True:
        labs, changed = j_recon_round(labs, ms, sent)
        edges = [band_ccl.recon_edges(p) for p in pieces]
        for k, p in enumerate(pieces):
            band_ccl.recon_min(p, edges[k], edges[k - 1][:, 1] if k > 0 else None,
                               edges[k + 1][:, 0] if k < n - 1 else None)
        if not any(changed):
            break
    table, sums, n_loc = j_table_sums(labs[b], locs[b], ms[b], keys[b], b * Hb, C, sent)
    got_table = band_ccl.piece_table(pieces[b], C)
    np.testing.assert_array_equal(got_table.numpy(), table)
    np.testing.assert_array_equal(band_ccl.piece_sums(pieces[b], got_table).numpy(), sums)
    np.testing.assert_array_equal(pieces[b].nroots.numpy(), n_loc)
    if case == "overflow_band_1":
        assert n_loc.tolist() == [40, 40]
        assert ((table <= sent).sum(1) == 31).all()
