"""Kernel K6's plain version on the CPU against tpuva's dense stats.

tpuva_torch.ops.label.root_stats_plain (the plain version of K6, which
ops.ccl.root_stats takes for CPU tensors) is held, through
_stats_from_root and relabel_dense, against tpuva.ops.label.
_stats_from_root and relabel_dense (XLA) on the same root-key labels,
tpuva's label_components of numpy-seeded masks: 4- and 8-connectivity,
compute_bbox and compute_labels each way, C = 1, 8 and 64 with frames
that hold more than C components. The batch holds an empty frame, an
all-foreground frame and random masks, at an odd H and an odd W that is
not a multiple of 256 (the strips of K6 are 2 x 256 and 1 x 512 pixels).
Tolerance: exact. Labels, areas, boxes and coordinate sums are integers,
and the float32 centroid is the same single division of the same float32
values.

The CUDA kernel has no CPU mode: tests/test_torch_kernels.py holds it
against this plain version on a card, and chip_smoke.py at the main
path's shapes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuva.ops import label as jl
from tpuva_torch.ops import connected_components_with_stats
from tpuva_torch.ops import ccl
from tpuva_torch.ops.label import _stats_from_root, _stats_from_root_plain, relabel_dense
from test_torch_kernels import one_torch_thread  # noqa: F401
from tpuva_torch.scenes import edge_strip_scene

STATS = ("labels", "count", "area", "bbox", "centroid", "centroid_sum", "overflow")


def stats_batch():
    """(6, 37, 301) masks: empty, every pixel, random at 0.1, 0.3 and 0.5
    (hundreds of components each), and a few blobs."""
    rng = np.random.default_rng(17)
    m = np.zeros((6, 37, 301), np.uint8)
    m[1] = 255
    for i, p in enumerate((0.1, 0.3, 0.5)):
        m[2 + i] = (rng.random((37, 301)) < p) * 255
    m[5, 3:9, 250:270] = 255  # across the 256-column strip border
    m[5, 20:37, 0:4] = 255  # the ragged last row
    m[5, 30, 290:301] = 255
    return m


BATCH = stats_batch()


@pytest.fixture(scope="module", params=[4, 8], ids=["conn4", "conn8"])
def roots(request):
    """(connectivity, tpuva's root-key labels of BATCH as numpy)."""
    conn = request.param
    return conn, np.asarray(jl.label_components(jnp.asarray(BATCH), connectivity=conn))


@pytest.mark.parametrize("labels", [False, True], ids=["no_labels", "labels"])
@pytest.mark.parametrize("bbox", [False, True], ids=["no_bbox", "bbox"])
@pytest.mark.parametrize("C", [1, 8, 64])
def test_stats_from_root_matches_tpuva(roots, C, bbox, labels):
    conn, root = roots
    ref = jl._stats_from_root(jnp.asarray(root), max_components=C, connectivity=conn,
                              compute_bbox=bbox, compute_labels=labels)
    assert int(np.asarray(ref["count"]).max()) == C  # frames with more than C
    for got in (_stats_from_root(torch.from_numpy(root.copy()), C, conn, bbox, labels),
                _stats_from_root_plain(torch.from_numpy(root.copy()), C, conn, bbox, labels)):
        for k in STATS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("C", [1, 8, 64])
def test_relabel_dense_plain_matches_tpuva(roots, C):
    conn, root = roots
    ref_dense, ref_count = jl.relabel_dense(jnp.asarray(root), max_components=C,
                                            connectivity=conn)
    dense, count = relabel_dense(torch.from_numpy(root.copy()), C, conn)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(ref_dense))
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref_count))
    # 2-D input
    dense2, count2 = relabel_dense(torch.from_numpy(root[3].copy()), C, conn)
    np.testing.assert_array_equal(dense2.numpy(), np.asarray(ref_dense)[3])
    assert int(count2) == int(np.asarray(ref_count)[3])


@pytest.mark.parametrize("connectivity", [4, 8])
def test_root_stats_parts_agree(connectivity):
    """root_stats on the CPU returns what it was asked for, the parts the
    kernel returns on a card: counts, int64 sums, int32 bbox extremes with
    2^30 / -1 for an absent component, dense ids."""
    root = torch.from_numpy(np.array(jl.label_components(jnp.asarray(BATCH),
                                                         connectivity=connectivity)))
    count, sums, lohi, dense = ccl.root_stats(root, 5000, connectivity, True, True, True)
    assert sums.dtype == torch.int64 and lohi.dtype == torch.int32 and dense.dtype == torch.int32
    assert count[0] == 0 and count[1] == 1 and int(count.max()) < 5000
    absent = lohi[0]  # the empty frame
    assert (absent[:, :2] == 1 << 30).all() and (absent[:, 2:] == -1).all()
    assert torch.equal(lohi[1, 0], torch.tensor([0, 0, 300, 36], dtype=torch.int32))
    assert int(sums[..., 0].sum()) == int((BATCH != 0).sum())
    assert ccl.root_stats(root, 8, connectivity, sums=False, labels=True)[1:3] == (None, None)
    with pytest.raises(ValueError):
        ccl.root_stats(root, 8, connectivity, sums=False, bbox=True)
    with pytest.raises(ValueError):
        ccl.root_stats(root, 8, connectivity, strip_occ=torch.zeros((6, 1, 1), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ccl.root_stats(root.long(), 8, connectivity)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_root_occupancy_plain(connectivity):
    """K6's strips: 8-connected K3's (2 x 256 pixels, strip_shape), 4-
    connected 512 columns of one row; a strip is occupied where it holds a
    nonzero label."""
    m = torch.from_numpy(edge_strip_scene())
    occ = ccl.root_occupancy_plain(m, connectivity)
    N, H, W = m.shape
    R, S = ccl.root_strip_shape(H, W, connectivity)
    assert occ.shape == (N, R, S) and occ.dtype == torch.uint8
    rows, cols = (2, 256) if connectivity == 8 else (1, 512)
    for n, r, c in ((0, R - 1, S - 1), (5, 0, 0), (4, R - 1, S - 1), (1, 3, S - 1)):
        block = m[n, rows * r:rows * (r + 1), cols * c:cols * (c + 1)]
        assert int(occ[n, r, c]) == int(bool(block.any()))
    assert int(occ[5].sum()) == 0 and int(occ[4].sum()) == R * S


def test_cpu_calls_launch_no_kernel():
    """CPU tensors take the plain versions: K3's and K6's launch counters
    stay at 0 through every entry point."""
    ccl.label_components_tiled.launches = 0
    ccl.root_stats.launches = ccl.root_stats.occ_launches = 0
    m = torch.from_numpy(BATCH[:3])
    for conn in (4, 8):
        connected_components_with_stats(m, 8, conn)
        root, occ = ccl.root_labels(m, conn)
        assert occ is None
        relabel_dense(root, 8, conn)
        _stats_from_root(root, 8, conn)
        ccl.label_components_tiled(m, conn)
    assert ccl.label_components_tiled.launches == 0
    assert ccl.root_stats.launches == 0 and ccl.root_stats.occ_launches == 0
