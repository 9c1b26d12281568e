"""The port's tracker (tpuva_torch.track) against tpuva.track, step by
step on the same numpy detections: assignments, every TrackState field
and every row compared exactly (positions move by one-term masked sums
and the cost is the same float32 op sequence, so nothing rounds
differently)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuva.track import init_track_state as jax_init, track_update as jax_update
from tpuva.track.assign import greedy_assign as jax_greedy
from tpuva.track.assign import hungarian_assign as jax_hungarian
from tpuva_torch.track.assign import greedy_assign, hungarian_assign
from tpuva_torch.track.table import init_track_state, track_update
from tpuva_torch.scenes import det_sequence
from test_torch_kernels import one_torch_thread  # noqa: F401

BIG = np.float32(1e30)


def random_cost(rng, T, D, frac_valid=0.8):
    cost = rng.uniform(0, 100, (T, D)).astype(np.float32)
    return np.where(rng.random((T, D)) > frac_valid, BIG, cost)


CONTESTED = [
    np.array([[1.0, 1.5], [9.0, 9.5], [9.0, 9.9]], np.float32),  # shared argmin
    np.array([[2.0, 5.0], [2.0, 7.0], [8.0, 1.0]], np.float32),  # column tie
    np.array([[3.0, 1.0, 2.0, 8.0]], np.float32),  # D > T
    np.array([[5.0, 5.0], [5.0, 5.0]], np.float32),  # all ties
    np.full((3, 2), BIG, np.float32),  # nothing pairable
]


@pytest.mark.parametrize("T,D", [(4, 4), (8, 3), (3, 8), (16, 8), (1, 1)])
def test_assigners_match_tpuva(T, D):
    rng = np.random.default_rng(T * 31 + D)
    costs = [random_cost(rng, T, D) for _ in range(15)]
    # contested: several columns share a row minimum
    for _ in range(5):
        c = rng.uniform(0, 100, (T, D)).astype(np.float32)
        c[rng.integers(0, T)] = rng.uniform(0, 3, D).astype(np.float32)
        costs.append(c)
    for cost in costs + [c for c in CONTESTED if c.shape == (T, D)]:
        md = float(rng.uniform(10, 90))
        for mine, ref in ((greedy_assign, jax_greedy), (hungarian_assign, jax_hungarian)):
            got = mine(torch.from_numpy(cost), md).numpy()
            np.testing.assert_array_equal(got, np.asarray(ref(jnp.asarray(cost), md)))


def test_contested_cases_match_tpuva():
    for cost in CONTESTED:
        for md in (3.0, 50.0):
            got = hungarian_assign(torch.from_numpy(cost), md).numpy()
            np.testing.assert_array_equal(got, np.asarray(jax_hungarian(jnp.asarray(cost), md)))


@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
@pytest.mark.parametrize("kind", ["churn", "empty", "contested"])
def test_track_update_matches_tpuva(kind, assigner):
    D, T = 5, 6
    dets, valid = det_sequence(kind, D, seed=len(kind))
    js = jax_init(T)
    ts = init_track_state(T, "cpu")
    kw = dict(max_dist=25.0, death_patience=3, assigner=assigner)
    n_rows = 0
    for t in range(dets.shape[0]):
        js, jrows, jrv = jax_update(js, jnp.asarray(dets[t]), jnp.asarray(valid[t]), jnp.int32(t), **kw)
        ts, rows, rv = track_update(ts, torch.from_numpy(dets[t]), torch.from_numpy(valid[t]), t, **kw)
        np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        for field in ("pos", "tid", "missed", "active", "next_id"):
            np.testing.assert_array_equal(
                getattr(ts, field).numpy(), np.asarray(getattr(js, field)), err_msg=f"{field} t={t}"
            )
        n_rows += int(rv.sum())
    assert n_rows > 0


# (kind, T, D): T > D and T < D; "crowd" with a small table fills it, so
# births are refused for want of a slot; "contested" and "cloud" take the
# Hungarian search's slow path on both sides of the square. Then the edges
# of K5's register kernel (scan_plan): T and D of 1, 8, 16 and 32 take it,
# 33 the table kernel; the crowd fills its table (births at capacity), the
# contested streams and the clouds take Jonker-Volgenant
SCAN_CASES = [("churn", 6, 4), ("empty", 3, 8), ("contested", 6, 4), ("contested", 3, 8),
              ("crowd", 3, 8), ("crowd", 6, 4), ("cloud", 8, 5), ("cloud", 4, 7),
              ("contested", 1, 1), ("contested", 16, 8), ("crowd", 16, 32), ("cloud", 32, 32),
              ("contested", 33, 8), ("cloud", 33, 33)]


@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
@pytest.mark.parametrize("kind,T,D", SCAN_CASES, ids=[f"{k}-T{t}-D{d}" for k, t, d in SCAN_CASES])
def test_track_scan_plain_matches_tpuva_finish_batch(kind, T, D, assigner):
    """track_scan_plain against tpuva's _finish_batch (its lax.scan of
    track_update) over a whole 64-frame batch, from a state carried out of
    an earlier batch and at a frame index near 2^24 (where float32 frames
    round): rows, row_valid and the final state, exactly. The detections
    reach tpuva's scan through its extract_detections, fed stats that hold
    them as components."""
    import tpuva.graph.config as jcfg
    from tpuva.graph.pipeline import PipelineCarry, _finish_batch
    from tpuva_torch.track.scan import track_scan, track_scan_plain

    dets, valid = det_sequence(kind, D, frames=96, seed=T * 7 + D)
    cfg = jcfg.PipelineConfig(
        segment=jcfg.SegmentConfig(threshold=35.0, min_area=0, max_blobs=D),
        track=jcfg.TrackConfig(max_dist=40.0, death_patience=3, max_tracks=T, assigner=assigner),
    )
    kw = dict(max_dist=40.0, death_patience=3, assigner=assigner)

    # tpuva: one batch of 96 frames
    frame0 = 2**24 - 40
    n = valid.sum(1).astype(np.int32)
    area = np.zeros((96, D + 1), np.int32)
    cent = np.zeros((96, D + 1, 2), np.float32)
    area[:, 1:] = dets[:, :, 2]
    cent[:, 1:] = dets[:, :, :2]
    stats = {"area": jnp.asarray(area), "centroid": jnp.asarray(cent), "count": jnp.asarray(n),
             "centroid_sum": jnp.zeros((96, D + 1, 2), jnp.int32)}
    carry = PipelineCarry(bg=jnp.zeros((1, 1)), bg_valid=jnp.bool_(True), track=jax_init(T),
                          frame_idx=jnp.int32(frame0))
    jcarry, out = _finish_batch(cfg, carry, stats, jnp.zeros((96, 1, 1), jnp.uint8), carry.bg, False)
    jrows, jrv = np.asarray(out["rows"]), np.asarray(out["row_valid"])
    # the port: the first 32 frames give a lived-in table, then the scan of
    # the other 64 from it
    ts, rows0, rv0 = track_scan_plain(init_track_state(T, "cpu"), torch.from_numpy(dets[:32]),
                                      torch.from_numpy(valid[:32]),
                                      torch.tensor(frame0, dtype=torch.int32), **kw)
    before = [x.clone() for x in ts]
    args = (torch.from_numpy(dets[32:]), torch.from_numpy(valid[32:]),
            torch.tensor(frame0 + 32, dtype=torch.int32))
    got_ts, rows, rv = track_scan_plain(ts, *args, **kw)
    np.testing.assert_array_equal(torch.cat([rv0, rv]).numpy(), jrv)
    np.testing.assert_array_equal(torch.cat([rows0, rows]).numpy().view(np.int32),
                                  jrows.view(np.int32))
    for field in ("pos", "tid", "missed", "active", "next_id"):
        np.testing.assert_array_equal(getattr(got_ts, field).numpy(),
                                      np.asarray(getattr(jcarry.track, field)), err_msg=field)
    assert int(rv.sum()) > 0 and len(set(rows.numpy()[..., 1].ravel())) < 64  # frames rounded
    # the wrapper takes the plain version for CPU tensors, and leaves its input alone
    w_ts, w_rows, w_rv = track_scan(ts, *args, **kw)
    assert torch.equal(w_rows, rows) and torch.equal(w_rv, rv)
    assert all(torch.equal(a, b) for a, b in zip(w_ts, got_ts))
    assert all(torch.equal(a, b) for a, b in zip(ts, before))


def test_scan_plan():
    """K5's shape dispatch: the register kernel (array extent 8, 16 or 32)
    up to 32 x 32, then the table kernel in shared memory, then in global
    scratch past a CTA's shared memory; the register kernel's shared memory
    holds the Jonker-Volgenant arrays, two staged chunks of detections and
    a chunk of rows, each 16-byte aligned."""
    from tpuva_torch.track.scan import CHUNK_FRAMES, SMEM_LIMIT, scan_plan

    F = CHUNK_FRAMES
    assert F % 16 == 0  # a chunk's rows and flags start 16-byte aligned
    for T in (1, 16, 32):
        for D, kd in ((1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32)):
            p = scan_plan(T, D)
            table = 4 * (10 * T + T * D + 3 * D + 7 * (max(T, D) + 1))
            up = lambda x: -(-x // 16) * 16  # noqa: E731
            assert p == ("registers", kd, up(table) + 2 * up(12 * F * D) + 2 * up(F * D)
                         + up(20 * F * D) + up(F * D), 0), (T, D)
            assert p.smem_bytes <= SMEM_LIMIT
    assert scan_plan(16, 8).smem_bytes == 13760  # the bench's table
    for T, D in ((33, 8), (16, 33), (64, 16), (33, 33), (200, 200)):
        p = scan_plan(T, D)
        assert p.kernel == "shared" and p.kd == 0 and p.scratch_bytes == 0
        assert p.smem_bytes == 4 * (10 * T + T * D + 3 * D + 7 * (max(T, D) + 1))
    p = scan_plan(600, 100)
    assert p.kernel == "global" and p.smem_bytes == 0 and p.scratch_bytes > SMEM_LIMIT
    with pytest.raises(ValueError):
        scan_plan(0, 4)
