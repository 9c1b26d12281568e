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
from tpuva_torch.ops.ccl import label_stats
from tpuva_torch.ops.label import _scan_key, label_components
from test_torch_kernels import mixed_scene, one_torch_thread, u_shape  # noqa: F401

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
