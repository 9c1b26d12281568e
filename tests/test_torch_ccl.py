"""Kernel K2's plain version (tpuva_torch.ops.ccl.label_stats on CPU)
against the Pallas CCL tpuva.ops.pallas.ccl.label_components_tiled_raw +
the stats step tpuva.ops.label._stats_from_compact (interpret mode, as
tests/test_ccl_raw.py runs them) and against the XLA
connected_components_with_stats. Every stats field is compared exactly:
counts, areas and coordinate sums are integers, and the float32 centroid
is the same single division, so it is compared bit for bit.

The CUDA kernel has no CPU mode: tests/test_torch_kernels.py holds it
against this plain version on a card, and chip_smoke.py at the main
path's shapes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax import lax

from tpuva.ops.label import (
    _scan_key as jax_scan_key,
    _stats_from_compact,
    connected_components_with_stats,
    label_components as jax_label_components,
)
from tpuva.ops.pallas.ccl import label_components_tiled_raw
from tpuva_torch.ops.ccl import label_stats, strip_occupancy_plain, strip_shape
from tpuva_torch.ops.label import _scan_key, label_components
from test_torch_kernels import one_torch_thread  # noqa: F401
from tpuva_torch.scenes import mixed_scene, u_shape

KEYS = ("count", "area", "centroid", "centroid_sum", "overflow")


def assert_stats_equal(ref, got):
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def pallas_stats(mask, C, slots=64):
    m = jnp.asarray(mask)
    _n, H, W = m.shape
    Hp, Wp = -(-H // 64) * 64, -(-W // 256) * 256
    mp = jnp.pad(m, ((0, 0), (0, Hp - H), (0, Wp - W)))
    o1 = lax.reduce_window(mp, jnp.uint8(0), lax.max, (1, 1, 256), (1, 1, 256), "VALID")
    so = lax.reduce_window(o1, jnp.uint8(0), lax.max, (1, 2, 1), (1, 2, 1), "VALID")
    _lab, cbuf, conv = label_components_tiled_raw(
        mp, so, H, W, frames_per_step=4, compact_slots=slots
    )
    assert bool(conv)
    return _stats_from_compact(cbuf, so, H, W, max_components=C)


def test_plain_matches_pallas_mixed_scene():
    mask = mixed_scene()
    for C in (16, 64):
        ref = pallas_stats(mask, C)
        got = label_stats(torch.from_numpy(mask), C)
        assert_stats_equal(ref, got)
    assert int(got["count"][4]) == 64  # 840 dots, cut at C


@pytest.mark.parametrize("h,w,p", [(64, 256, 0.25), (50, 100, 0.45), (96, 300, 0.05)])
def test_plain_matches_connected_components(h, w, p):
    """The random-mask scenes of tests/test_ccl_raw.py."""
    rng = np.random.default_rng(3)
    mask = ((rng.random((3, h, w)) < p) * 255).astype(np.uint8)
    mask[1] = 0
    for C in (8, 64):
        ref = connected_components_with_stats(
            jnp.asarray(mask), max_components=C, compute_bbox=False,
            compute_labels=False,
        )
        assert_stats_equal(ref, label_stats(torch.from_numpy(mask), C))


def test_root_labels_match_tpuva():
    """The plain labels are tpuva's min-scan-key root labels, including a
    component whose minimum key is reached only backwards (the regression
    scene of tests/test_ccl_raw.py) and a U across tiles."""
    m = np.zeros((2, 192, 768), np.uint8)
    m[0, 0:9, 280:284] = 255
    m[0, 5:9, 10:301] = 255
    m[0, 5:101, 10:14] = 255
    m[1] = u_shape(192, 768)
    ref = np.asarray(jax_label_components(jnp.asarray(m)))
    got = label_components(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, ref)
    stats = label_stats(torch.from_numpy(m), 8)
    assert stats["count"].tolist() == [1, 1]
    assert stats["ccl_converged"] is True


def test_scan_key_copy_matches_original():
    for H, W in [(1, 1), (3, 5), (8, 8), (130, 280), (1080, 1920)]:
        for conn in (4, 8):
            for a, b in zip(_scan_key(H, W, conn), jax_scan_key(H, W, conn)):
                np.testing.assert_array_equal(a, b)


def test_odd_sizes_and_single_pixels():
    rng = np.random.default_rng(5)
    for shape in [(2, 1, 1), (1, 3, 1), (2, 7, 9), (1, 1, 33)]:
        mask = ((rng.random(shape) < 0.5) * 255).astype(np.uint8)
        ref = connected_components_with_stats(
            jnp.asarray(mask), max_components=8, compute_bbox=False,
            compute_labels=False,
        )
        assert_stats_equal(ref, label_stats(torch.from_numpy(mask), 8))


def tpuva_strip_occ(mask_padded):
    """tpuva's _post_mask_stage occupancy of a mask padded to 64 x 256."""
    o1 = lax.reduce_window(jnp.asarray(mask_padded), jnp.uint8(0), lax.max, (1, 1, 256),
                           (1, 1, 256), "VALID")
    return lax.reduce_window(o1, jnp.uint8(0), lax.max, (1, 2, 1), (1, 2, 1), "VALID")


def padded_scene(shape, p, seed):
    """Random blobs in an (N, H, W) mask, its zero padding to 64 x 256
    (tpuva's CCL grid) and the strip occupancy of that padding."""
    rng = np.random.default_rng(seed)
    N, H, W = shape
    mask = ((rng.random(shape) < p) * 255).astype(np.uint8)
    mask[:, : H // 3] = 0  # empty strips
    mask[-1] = 0
    Hp, Wp = -(-H // 64) * 64, -(-W // 256) * 256
    padded = np.zeros((N, Hp, Wp), np.uint8)
    padded[:, :H, :W] = mask
    return mask, padded, np.array(tpuva_strip_occ(padded))


@pytest.mark.parametrize("shape", [(3, 120, 256), (3, 96, 300), (2, 37, 513)],
                         ids=["aligned", "unaligned", "odd"])
def test_strip_occupancy_matches_tpuva(shape):
    """The derived occupancy the kernels take where no strip_occ is given:
    tpuva's two reduce_windows over the padded mask (which keep the mask's
    255 where the port keeps 1)."""
    mask, padded, occ = padded_scene(shape, 0.01, seed=sum(shape))
    occ = (occ != 0).astype(np.uint8)
    got = strip_occupancy_plain(torch.from_numpy(mask)).numpy()
    R, S = strip_shape(*shape[1:])
    assert got.shape == (shape[0], R, S)
    np.testing.assert_array_equal(got, occ[:, :R, :S])
    assert not occ[:, R:].any() and not occ[:, :, S:].any()
    np.testing.assert_array_equal(strip_occupancy_plain(torch.from_numpy(padded)).numpy(), occ)
    assert occ.any() and not occ.all()


@pytest.mark.parametrize("shape, p, ref_kind", [((3, 120, 256), 0.05, "pallas"),
                                                ((3, 96, 300), 0.3, "xla"),
                                                ((2, 37, 513), 0.45, "cropped")],
                         ids=["aligned_sparse", "unaligned_dense", "odd_dense"])
def test_label_stats_strip_occ_matches_tpuva(shape, p, ref_kind):
    """label_stats on the padded mask with its strip occupancy, as
    _post_mask_stage hands them to label_components_tiled_raw: against
    that Pallas kernel and _stats_from_compact (interpret mode), or
    tpuva's XLA connected_components_with_stats, and always against
    label_stats of the cropped mask: every field equal. The plain version
    computes the stats of the (H, W) image whatever the occupancy says: an
    all-empty and an all-occupied one give the same."""
    mask, padded, occ = padded_scene(shape, p, seed=7)
    N, H, W = shape
    C = 16
    ref = label_stats(torch.from_numpy(mask), C)
    if ref_kind == "pallas":
        _lab, cbuf, conv = label_components_tiled_raw(
            jnp.asarray(padded), jnp.asarray(occ), H, W, frames_per_step=4, compact_slots=64)
        assert bool(conv)
        assert_stats_equal(_stats_from_compact(cbuf, jnp.asarray(occ), H, W, max_components=C),
                           ref)
    elif ref_kind == "xla":
        assert_stats_equal(connected_components_with_stats(
            jnp.asarray(mask), max_components=C, compute_bbox=False, compute_labels=False), ref)
    ref = {k: v.numpy() for k, v in ref.items() if k in KEYS}
    for so in (occ, np.zeros_like(occ), np.ones_like(occ)):
        got = label_stats(torch.from_numpy(padded), C, strip_occ=torch.from_numpy(so), H=H, W=W)
        assert_stats_equal(ref, got)
    with pytest.raises(ValueError):
        label_stats(torch.from_numpy(padded), C, strip_occ=torch.from_numpy(occ[:, :1]), H=H, W=W)
    with pytest.raises(ValueError):
        label_stats(torch.from_numpy(padded), C, strip_occ=torch.from_numpy(occ))


def tpuva_limbs(sums):
    """(N, C, 3) int64 (area, sum x, sum y) -> tpuva's (N, C, 7) float32
    exact-integer limbs (area; x and y as 6-bit, 6-bit and high limbs) that
    its _assemble_stats recombines in int32 to the same value mod 2^32."""
    a, sx, sy = (sums[..., k] for k in range(3))
    cols = [a]
    for v in (sx, sy):
        cols += [v & 63, (v >> 6) & 63, v >> 12]
    limbs = np.stack(cols, axis=-1)
    assert (np.abs(limbs) < 2**24).all()  # float32 holds each limb exactly
    return limbs.astype(np.float32)


@pytest.mark.parametrize("N,C,H,W", [(4, 1, 1080, 1920), (5, 64, 40000, 50000),
                                     (3, 8, 7, 9), (2, 64, 1088, 2048)])
def test_assemble_stats_matches_tpuva_on_extreme_sums(N, C, H, W):
    """The port's _assemble_stats (on the CPU; K2's epilogue holds it on the
    card) against tpuva/ops/label.py's on the same integer sums, every
    field bit for bit: component sums that wrap int32 (each and in the
    totals), a background row whose coordinate sums pass 2^31 (clamped),
    zero-area rows, components past the count, C = 1 and 64."""
    from tpuva.ops.label import _assemble_stats as jax_assemble
    from tpuva_torch.ops.label import _assemble_stats

    rng = np.random.default_rng(N * 100 + C)
    area = rng.integers(0, 2**20, (N, C))
    area[:, ::3] = 0  # zero-area rows
    sx = rng.integers(0, 2**35, (N, C))  # past int32: wraps
    sy = rng.integers(0, 2**33, (N, C))
    sx[0, 0], sy[-1, -1] = 2**31 - 1, 2**32 - 5  # the edges of the wrap
    sums = np.stack([area, sx, sy], axis=-1).astype(np.int64)
    roots = rng.integers(0, 2 * C + 2, N).astype(np.int32)
    count = np.minimum(roots, C).astype(np.int32)
    got = _assemble_stats(torch.from_numpy(count), torch.from_numpy(sums), H, W)
    ref = jax_assemble(jnp.asarray(tpuva_limbs(sums)), jnp.asarray(roots), H, W, C)
    for k, r in zip(("count", "area", "centroid", "centroid_sum"), ref[:4]):
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      np.asarray(r).view(np.int32), err_msg=k)
    assert (got["area"][:, 1:] == 0).any()
    if H * W > 2**30:  # the background's coordinate sums clamped at 2^31 - 128
        assert (got["centroid_sum"][:, 0] == 2**31 - 128).all()


def test_k2_workspace_layout():
    """K2's scratch arrays: 16-byte aligned, disjoint, in the order given,
    each of its size (a block, a strip, a tile, a component); the stats
    views cover their tensor once."""
    from tpuva_torch.ops.ccl import STATS_FIELDS, k2_workspace, stats_views

    for (N, Hm, Wm, C) in ((256, 1088, 2048, 32), (3, 7, 9, 1), (2, 250, 333, 1024)):
        Hb, Wb = (Hm + 1) // 2, (Wm + 1) // 2
        R, S = strip_shape(Hm, Wm)
        layout, total = k2_workspace(N, Hm, Wm, C)
        tiles = -(-Hb // 16) * -(-Wb // 32)
        want = {"parent": 4 * N * Hb * Wb, "rc": 4 * N * R * S, "list": 8 * N * tiles,
                "table": 4 * N * C, "sums": 12 * N * C, "nlist": 4, "bits": N * Hb * Wb,
                "fine": N * R * S}
        assert {k: n for k, (_o, n) in layout.items()} == want
        end = 0
        for name in want:
            off, n = layout[name]
            assert off % 16 == 0 and off >= end
            end = off + n
        assert end <= total < end + 16
        out = torch.arange(N * (2 + 5 * (C + 1)), dtype=torch.int32)
        views = stats_views(out, N, C)
        assert tuple(views) == STATS_FIELDS
        words = torch.cat([v.reshape(-1).view(torch.int32) for v in views.values()])
        assert torch.equal(words, out)
        assert views["centroid"].dtype == torch.float32
        assert views["area"].shape == (N, C + 1) and views["centroid_sum"].shape == (N, C + 1, 2)
