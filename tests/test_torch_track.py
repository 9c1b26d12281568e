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


def det_sequence(kind, D, frames=60, seed=0):
    """(dets (F, D, 3) float32, valid (F, D) bool) detection streams."""
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
        k = 0
        for key in sorted(objs):
            if kind == "churn":
                objs[key] = objs[key] + rng.uniform(-6, 6, 2)
            if k < D:
                dets[t, k] = (objs[key][0], objs[key][1], rng.integers(30, 90))
                valid[t, k] = True
                k += 1
    return dets, valid


@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
@pytest.mark.parametrize("kind", ["churn", "empty", "contested"])
def test_track_update_matches_tpuva(kind, assigner):
    D, T = 5, 6
    dets, valid = det_sequence(kind, D, seed=len(kind))
    js = jax_init(T)
    ts = init_track_state(T)
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
