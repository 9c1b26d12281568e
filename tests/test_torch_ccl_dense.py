"""Kernel K3's plain version and the dense stats on the CPU against tpuva.

tpuva_torch.ops.label.label_components (the plain version of K3, which
ops.ccl.label_components_tiled takes for CPU tensors) is held against both
tpuva.ops.label.label_components (XLA) and the Pallas kernel
tpuva.ops.pallas.ccl.label_components_tiled (interpret mode, as
tests/test_ccl_raw.py runs it), for 4- and 8-connectivity, and on the
scenes of K3 4-connected's occupancy skip (tpuva_torch.scenes.conn4_scene:
components across 16 x 32 tiles and the 512-column strip border, diagonal
contacts across a tile corner beside empty tiles, H % 16 != 0 and
W % 4 != 0, empty and full frames), whose labels' strip occupancy
(root_occupancy_plain, what K3 hands K6) is the mask's own. relabel_dense
and connected_components_with_stats (labels, bbox and every stats field)
are held against tpuva's. Tolerance: exact everywhere. Labels, areas,
boxes and coordinate sums are integers, and the float32 centroid is the
same single division of the same float32 values.

The CUDA kernel has no CPU mode: tests/test_torch_kernels.py holds it
against this plain version on a card, and chip_smoke.py at the main
path's shapes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuva.ops import label as jl
from tpuva.ops.pallas.ccl import label_components_tiled as pallas_labels
from tpuva_torch.ops import connected_components_with_stats
from tpuva_torch.ops.ccl import label_components_tiled, root_labels, root_occupancy_plain
from tpuva_torch.ops.label import label_components, relabel_dense
from test_torch_kernels import one_torch_thread  # noqa: F401
from tpuva_torch.scenes import conn4_scene, mixed_scene, u_shape

STATS = ("labels", "count", "area", "bbox", "centroid", "centroid_sum", "overflow")


def backward_minimum_scene():
    """A component whose minimum key is reached only backwards (the
    regression scene of tests/test_ccl_raw.py), cut to 130 x 280."""
    m = np.zeros((130, 280), np.uint8)
    m[0:9, 250:254] = 255
    m[5:9, 10:254] = 255
    m[5:101, 10:14] = 255
    return m


def scenes():
    """Scenes of one shape, (2, 130, 280), so that each jitted tpuva
    function compiles once per connectivity, and the small sizes."""
    rng = np.random.default_rng(11)
    mixed = mixed_scene()
    out = {
        "mixed_random_blobs": mixed[[0, 2]],
        "mixed_u_dots": mixed[[3, 4]],  # more components than C
        "u_backward_minimum": np.stack([u_shape(130, 280), backward_minimum_scene()]),
    }
    for p in (0.05, 0.25, 0.45):
        out[f"random_{p}"] = ((rng.random((2, 130, 280)) < p) * 255).astype(np.uint8)
    for h, w in ((1, 1), (7, 9), (1, 33)):
        out[f"size_{h}x{w}"] = ((rng.random((2, h, w)) < 0.5) * 255).astype(np.uint8)
    return out


SCENES = scenes()
# Pallas in interpret mode: <= 2 frames of 130 x 280, one compile per
# connectivity
PALLAS_SCENES = ("mixed_random_blobs", "mixed_u_dots", "u_backward_minimum", "random_0.25")
STATS_SCENES = PALLAS_SCENES + ("random_0.45", "size_7x9")


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_labels_match_xla(scene, connectivity):
    mask = SCENES[scene]
    ref = np.asarray(jl.label_components(jnp.asarray(mask), connectivity=connectivity))
    got = label_components(torch.from_numpy(mask), connectivity).numpy()
    np.testing.assert_array_equal(got, ref)
    # the K3 entry point takes the plain version for a CPU tensor
    lab, conv = label_components_tiled(torch.from_numpy(mask), connectivity,
                                       return_converged=True)
    assert conv is True
    np.testing.assert_array_equal(lab.numpy(), ref)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("scene", PALLAS_SCENES)
def test_plain_labels_match_pallas(scene, connectivity):
    mask = SCENES[scene]
    ref = np.asarray(pallas_labels(jnp.asarray(mask), connectivity=connectivity))
    got = label_components(torch.from_numpy(mask), connectivity).numpy()
    np.testing.assert_array_equal(got, ref)


def test_2d_input_and_bool_mask():
    m = u_shape(40, 60)
    ref = np.asarray(jl.label_components(jnp.asarray(m), connectivity=4))
    got = label_components_tiled(torch.from_numpy(m != 0), 4)
    assert got.shape == (40, 60) and int(got.max()) > 0
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError):
        label_components_tiled(torch.from_numpy(m), 6)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("scene", ["mixed_u_dots", "u_backward_minimum", "random_0.45", "size_1x33"])
def test_relabel_dense_matches_tpuva(scene, C, connectivity):
    root = np.asarray(jl.label_components(jnp.asarray(SCENES[scene]), connectivity=connectivity))
    ref_dense, ref_count = jl.relabel_dense(jnp.asarray(root), max_components=C,
                                            connectivity=connectivity)
    dense, count = relabel_dense(torch.from_numpy(root.copy()), C, connectivity)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(ref_dense))
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref_count))


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("scene", STATS_SCENES)
def test_connected_components_with_stats_matches_tpuva(scene, C, connectivity):
    mask = SCENES[scene]
    ref = jl.connected_components_with_stats(jnp.asarray(mask), max_components=C,
                                             connectivity=connectivity)
    got = connected_components_with_stats(torch.from_numpy(mask), max_components=C,
                                          connectivity=connectivity)
    for k in STATS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert got["ccl_converged"] is True


def test_stats_without_labels_and_bbox_and_2d_input():
    mask = SCENES["mixed_u_dots"]
    ref = jl.connected_components_with_stats(jnp.asarray(mask), max_components=8,
                                             compute_bbox=False, compute_labels=False)
    got = connected_components_with_stats(torch.from_numpy(mask), max_components=8,
                                          compute_bbox=False, compute_labels=False)
    for k in STATS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    ref2 = jl.connected_components_with_stats(jnp.asarray(mask[0]), max_components=8,
                                              connectivity=4)
    got2 = connected_components_with_stats(torch.from_numpy(mask[0]), max_components=8,
                                           connectivity=4)
    for k in STATS:
        assert got2[k].shape == np.asarray(ref2[k]).shape, k
        np.testing.assert_array_equal(got2[k].numpy(), np.asarray(ref2[k]), err_msg=k)


@pytest.mark.parametrize("H,W,reference", [(45, 601, "xla"), (45, 601, "pallas"),
                                           (48, 1024, "xla")])
def test_conn4_scenes_match_tpuva(H, W, reference):
    """The segment-skip scenes, 4-connected (and 8-connected against XLA):
    the plain labels and K3's CPU entry point equal tpuva's XLA and Pallas
    (interpret mode) labels; two components that touch only diagonally
    stay apart; the labels' strip occupancy equals the mask's."""
    mask = conn4_scene(H, W)
    conns = (4,) if reference == "pallas" else (4, 8)
    for conn in conns:
        if reference == "pallas":
            ref = np.asarray(pallas_labels(jnp.asarray(mask), connectivity=conn))
        else:
            ref = np.asarray(jl.label_components(jnp.asarray(mask), connectivity=conn))
        got = label_components(torch.from_numpy(mask), conn)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"connectivity {conn}")
        lab, occ = root_labels(torch.from_numpy(mask), conn)
        assert occ is None  # the CPU: no kernel hands an occupancy on
        np.testing.assert_array_equal(lab.numpy(), ref)
        if conn == 4:
            # the two blocks of frame 1 meet only at a tile corner: apart
            assert ref[1, 15, 31] != ref[1, 16, 32] and ref[1, 31, 511] != ref[1, 32, 512]
            S = -(-W // 512)
            padded = np.zeros((mask.shape[0], H, 512 * S), bool)
            padded[:, :, :W] = mask != 0
            np.testing.assert_array_equal(root_occupancy_plain(got, 4).numpy(),
                                          padded.reshape(-1, H, S, 512).any(-1))
        else:
            assert ref[1, 15, 31] == ref[1, 16, 32]  # 8-connected: one component
