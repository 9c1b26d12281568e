"""Kernel K6's plain version on the CPU against tpuva's dense stats.

tpuva_torch.ops.label.root_stats_plain (the plain version of K6, which
ops.ccl.root_stats takes for CPU tensors) is held, through
_stats_from_root and relabel_dense, against tpuva.ops.label.
_stats_from_root and relabel_dense (XLA) on the same root-key labels,
tpuva's label_components of numpy-seeded masks: 4- and 8-connectivity,
compute_bbox and compute_labels each way, C = 1, 8 and 64 with frames
that hold more than C components, and C = 1600, past every frame's
components. The batch holds an empty frame, an all-foreground frame and
random masks, at an odd H and an odd W that is not a multiple of 256 (the
strips of K6 are 2 x 256 and 1 x 512 pixels). K6's stats epilogue with
the bbox (_stats_dict, whose arithmetic the kernel repeats) is held to
tpuva's _assemble_stats and bbox rule on extreme sums that wrap int32.
Tolerance: bit-equal. Labels, areas, boxes and coordinate sums are
integers, and the float32 centroid is the same single division of the
same float32 values.

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
from tpuva_torch.ops.label import (
    _stats_dict, _stats_from_root, _stats_from_root_plain, relabel_dense,
)
from test_torch_ccl import tpuva_limbs
from test_torch_kernels import one_torch_thread  # noqa: F401
from tpuva_torch.scenes import conn4_scene, edge_strip_scene

STATS = ("labels", "count", "area", "bbox", "centroid", "centroid_sum", "overflow")
C_PAST = 1600  # more than any frame of BATCH holds (4-connected: 1488)


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
@pytest.mark.parametrize("C", [1, 8, 64, C_PAST])
def test_stats_from_root_matches_tpuva(roots, C, bbox, labels):
    conn, root = roots
    ref = jl._stats_from_root(jnp.asarray(root), max_components=C, connectivity=conn,
                              compute_bbox=bbox, compute_labels=labels)
    # frames with more than C, except past every frame's components
    assert (int(np.asarray(ref["count"]).max()) == C) == (C != C_PAST)
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
    ccl.label_components_tiled.launches = ccl.label_components_tiled.conn4_launches = 0
    ccl.root_stats.launches = ccl.root_stats.occ_launches = 0
    m = torch.from_numpy(BATCH[:3])
    for conn in (4, 8):
        connected_components_with_stats(m, 8, conn)
        root, occ = ccl.root_labels(m, conn)
        assert occ is None
        relabel_dense(root, 8, conn)
        _stats_from_root(root, 8, conn)
        ccl.root_stats_dict(root, 8, conn, strip_occ=ccl.root_occupancy_plain(root, conn))
        ccl.label_components_tiled(m, conn)
    assert ccl.label_components_tiled.launches == 0
    assert ccl.label_components_tiled.conn4_launches == 0
    assert ccl.root_stats.launches == 0 and ccl.root_stats.occ_launches == 0


@pytest.mark.parametrize("N,C,H,W", [(4, 1, 1080, 1920), (5, 64, 40000, 50000),
                                     (3, 8, 7, 9), (2, 64, 1088, 2048)])
def test_stats_dict_matches_tpuva_on_extreme_sums(N, C, H, W):
    """K6's stats epilogue with the bbox (_stats_dict on the plain
    version's outputs; the kernel's stats_epilogue repeats it) against
    tpuva's _assemble_stats and its bbox rule (tpuva/ops/label.py:727-737:
    (x, y, w, h) from the extremes, the background (0, 0, W, H), zeros
    where the area is 0) on the same integer sums and extremes, every
    field bit for bit: sums that wrap int32 (each and in the totals), a
    background row whose coordinate sums pass 2^31, zero-area rows,
    components past the count (extremes 2^30 / -1), C = 1 and 64."""
    from tpuva.ops.label import _assemble_stats as jax_assemble

    rng = np.random.default_rng(N * 100 + C + 7)
    area = rng.integers(0, 2**20, (N, C))
    area[:, ::3] = 0  # zero-area rows
    sx = rng.integers(0, 2**35, (N, C))  # past int32: wraps
    sy = rng.integers(0, 2**33, (N, C))
    sx[0, 0], sy[-1, -1] = 2**31 - 1, 2**32 - 5  # the edges of the wrap
    sums = np.stack([area, sx, sy], axis=-1).astype(np.int64)
    roots = rng.integers(0, 2 * C + 2, N).astype(np.int32)
    count = np.minimum(roots, C).astype(np.int32)
    lo = rng.integers(0, min(H, W), (N, C, 2))
    hi = lo + rng.integers(0, 1000, (N, C, 2))
    lohi = np.concatenate([lo, hi], axis=-1).astype(np.int32)
    absent = np.arange(C)[None, :] >= count[:, None]
    lohi[absent] = (1 << 30, 1 << 30, -1, -1)
    got = _stats_dict(torch.from_numpy(count), torch.from_numpy(sums), torch.from_numpy(lohi),
                      None, H, W)
    ref = jax_assemble(jnp.asarray(tpuva_limbs(sums)), jnp.asarray(roots), H, W, C)
    for k, r in zip(("count", "area", "centroid", "centroid_sum"), ref[:4]):
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      np.asarray(r).view(np.int32), err_msg=k)
    present = np.asarray(ref[4])
    bbox_c = np.stack([lohi[..., 0], lohi[..., 1], lohi[..., 2] - lohi[..., 0] + 1,
                       lohi[..., 3] - lohi[..., 1] + 1], axis=-1)
    bbox0 = np.broadcast_to(np.array([0, 0, W, H], np.int32), (N, 1, 4))
    bbox = np.where(present[:, :, None], np.concatenate([bbox0, bbox_c], axis=1), 0)
    np.testing.assert_array_equal(got["bbox"].numpy(), bbox.astype(np.int32))
    assert got["labels"].shape == (N, H, W) and got["labels"].stride() == (0, 0, 0)
    assert (got["area"][:, 1:] == 0).any() and (got["overflow"] == 0).all()


def test_k6_workspace_layout():
    """K6's scratch arrays: 16-byte aligned, disjoint, in order, each of
    its size (a strip each: list, roots, first ranks; deriving: each
    strip's roots and foreground; past shared memory: the table, the sums'
    low and high words, the extremes); the stats dict with its bbox covers
    stats_words(N, C, True) words once."""
    for (N, H, W, conn, C) in ((256, 1080, 1920, 8, 32), (3, 37, 301, 4, 13000),
                               (2, 45, 601, 4, 2000), (1, 7, 9, 8, 1)):
        R, S = ccl.root_strip_shape(H, W, conn)
        Q = R * S
        for derive in (False, True):
            for sums, box in ((True, False), (True, True), (False, False)):
                layout, total = ccl.k6_workspace(N, H, W, conn, C, derive, sums, box)
                want = {"list": 4 * N * Q, "lrc": 4 * N * Q, "loff": 4 * N * Q}
                if derive:
                    want.update(rcs=4 * N * Q, docc=N * Q)
                if ccl.k6_frame_bytes(C, sums, box) > ccl.K6_SMEM_BYTES:
                    want["table"] = 4 * N * C
                    want.update({"acc": 24 * N * C} if sums else {})
                    want.update({"box": 16 * N * C} if box else {})
                assert {k: n for k, (_o, n) in layout.items()} == want
                end = 0
                for name in want:
                    off, n = layout[name]
                    assert off % 16 == 0 and off >= end
                    end = off + n
                assert end <= total < end + 16
        out = torch.arange(ccl.stats_words(N, C, bbox=True), dtype=torch.int32)
        views = ccl.stats_views(out, N, C, bbox=True)
        assert tuple(views) == ccl.STATS_FIELDS + ("bbox",)
        assert views["bbox"].shape == (N, C + 1, 4)
        words = torch.cat([v.reshape(-1).view(torch.int32) for v in views.values()])
        assert torch.equal(words, out)
    assert ccl.k6_frame_bytes(32, True, False) <= ccl.K6_SMEM_BYTES  # the route's: shared
    assert ccl.k6_frame_bytes(2000, True, True) > ccl.K6_SMEM_BYTES  # the tests' global path


@pytest.mark.parametrize("connectivity", [4, 8])
def test_root_stats_dict_plain(connectivity):
    """root_stats_dict on the CPU (K6's stats dict entry point; the kernel
    on a card) is the plain version, root_stats_plain then _stats_dict,
    given an occupancy or not, on conn4_scene's ragged frames."""
    m = torch.from_numpy(conn4_scene())
    root = ccl.label_components_tiled(m, connectivity)
    for occ in (None, ccl.root_occupancy_plain(root, connectivity)):
        for bbox, labels in ((False, False), (True, True)):
            got = ccl.root_stats_dict(root, 8, connectivity, bbox, labels, strip_occ=occ)
            ref = _stats_from_root_plain(root, 8, connectivity, bbox, labels)
            for k in STATS:
                assert torch.equal(got[k], ref[k]), k
