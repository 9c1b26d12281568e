"""The port's copies of four public functions of tpuva against the
originals on seeded inputs: ops.background.background_update_masked,
track.table.track_update_straightline, utils.prepare_data_for_yaml and
utils.display_progress (tpuva's tests/test_aux.py:108 behaviour)."""

import io
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuva.ops.background import background_update_masked as jax_masked
from tpuva.track.table import init_track_state as jax_init
from tpuva.track.table import track_update_straightline as jax_straightline
from tpuva.utils import display_progress as jax_progress
from tpuva.utils import prepare_data_for_yaml as jax_prepare
from tpuva_torch.ops.background import background_update, background_update_masked
from tpuva_torch.scenes import det_sequence
from tpuva_torch.track.table import init_track_state, track_update, track_update_straightline
from tpuva_torch.utils import display_progress, prepare_data_for_yaml
from test_torch_kernels import one_torch_thread  # noqa: F401


def test_background_update_masked_matches_tpuva():
    """Masked-out pixels keep the old background, the others take
    background_update; both bit-equal to tpuva's, over four alphas and
    masks of several densities, (..., H, W) batches too."""
    rng = np.random.default_rng(8)
    bg = rng.uniform(0, 255, (3, 33, 47)).astype(np.float32)
    frame = rng.integers(0, 256, (3, 33, 47)).astype(np.float32)
    for alpha in (0.02, 0.05, 0.3, 1e-3):
        for density in (0.0, 0.3, 1.0):
            mask = rng.random((3, 33, 47)) < density
            got = background_update_masked(torch.from_numpy(bg), torch.from_numpy(frame), alpha,
                                           torch.from_numpy(mask)).numpy()
            want = np.asarray(jax_masked(jnp.asarray(bg), jnp.asarray(frame), alpha,
                                         jnp.asarray(mask)))
            np.testing.assert_array_equal(got, want, err_msg=f"alpha {alpha}, {density}")
            np.testing.assert_array_equal(got[~mask], bg[~mask])
            full = background_update(torch.from_numpy(bg), torch.from_numpy(frame), alpha)
            np.testing.assert_array_equal(got[mask], full.numpy()[mask])


@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
@pytest.mark.parametrize("kind", ["churn", "contested"])
def test_track_update_straightline_matches_tpuva(kind, assigner):
    """Step by step over a det_sequence stream (deaths and births on
    churn): rows, flags and every state field bit-equal to tpuva's
    track_update_straightline, and to the port's track_update."""
    D, T = 5, 6
    dets, valid = det_sequence(kind, D, seed=3 + len(kind))
    kw = dict(max_dist=25.0, death_patience=3, assigner=assigner)
    js, ts, ref = jax_init(T), init_track_state(T, "cpu"), init_track_state(T, "cpu")
    n_rows = 0
    for t in range(dets.shape[0]):
        js, jrows, jrv = jax_straightline(js, jnp.asarray(dets[t]), jnp.asarray(valid[t]),
                                          jnp.int32(t), **kw)
        d, v = torch.from_numpy(dets[t]), torch.from_numpy(valid[t])
        ts, rows, rv = track_update_straightline(ts, d, v, t, **kw)
        ref, rows_ref, rv_ref = track_update(ref, d, v, t, **kw)
        np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        assert torch.equal(rows, rows_ref) and torch.equal(rv, rv_ref)
        for field in ("pos", "tid", "missed", "active", "next_id"):
            np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                          np.asarray(getattr(js, field)), err_msg=f"{field} t={t}")
        n_rows += int(rv.sum())
    assert n_rows > 0


def test_prepare_data_for_yaml_matches_tpuva():
    """Nested dicts, lists and tuples of numpy arrays and scalars become the
    same plain Python values (types included) as tpuva's."""
    rng = np.random.default_rng(4)
    data = {
        "arr": rng.normal(size=(2, 3)).astype(np.float32),
        "ints": rng.integers(0, 9, 4),
        "scalars": (np.float64(1.5), np.int32(-3), np.bool_(True), np.uint8(7)),
        "nested": [{"a": np.arange(3)}, ("s", 2, 3.5, None)],
        "plain": "text",
    }
    got, want = prepare_data_for_yaml(data), jax_prepare(data)
    assert got == want

    def types(x):
        if isinstance(x, dict):
            return {k: types(v) for k, v in x.items()}
        if isinstance(x, list):
            return [types(v) for v in x]
        return type(x)

    assert types(got) == types(want)
    assert prepare_data_for_yaml(np.float32(2.0)) == 2.0 and prepare_data_for_yaml(5) == 5


def test_display_progress_matches_tpuva():
    """tpuva's tests/test_aux.py:108 check (items passed through, "5/5" in
    the output), and the same lines as tpuva's with the rates masked: with
    a total, without one (a generator), with a label, printing every item
    or only the final line."""
    buf = io.StringIO()
    assert list(display_progress(range(5), out=buf, every=0.0)) == list(range(5))
    assert "5/5" in buf.getvalue()

    def mask_rates(text):
        return re.sub(r" *[0-9.]+/s", " <rate>/s", text)

    for make, kw in ((lambda: range(7), dict(every=0.0)),
                     (lambda: (i for i in range(4)), dict(every=0.0, label="frames ")),
                     (lambda: range(3), dict(every=3600.0, total=10))):
        got, want = io.StringIO(), io.StringIO()
        assert list(display_progress(make(), out=got, **kw)) == list(
            jax_progress(make(), out=want, **kw))
        assert got.getvalue().count("\r") == want.getvalue().count("\r")
        assert got.getvalue().endswith("\n") and want.getvalue().endswith("\n")
        assert mask_rates(got.getvalue()) == mask_rates(want.getvalue())
