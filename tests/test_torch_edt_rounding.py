"""KE's float32 rounding tier on the CPU (ROADMAP F3): where the EDT's
float32 sums pass 2^24, tpuva's pass loop rounds on the way, and KE's
model, ``ops/distance.py::edt_model``, must give the loop's values, not
the exact squares.

- The 4096 x 94 mask whose only zero is at (0, 0): the model equals
  tpuva's ``distance_transform_edt_sq`` and the plain loop
  ``edt_sq_passes_plain`` bit for bit with the same passes; at (4095, 93)
  all three hold 16,777,672, where the exact square is 16,777,674.
- ``f_table``, the column loop's values f(d), equals the chained float32
  sum and d^2 up to 4096; its first rounded entry is f(4097);
  ``device_f_table`` uploads it once a height and device.
- Thin masks past 4096 px a side, zeros placed so that sums pass 2^24:
  the model against the plain loop (tpuva's loop is the same one).
"""

import numpy as np
import pytest
import torch

import tpuva.ops as jops
from tpuva_torch.ops import distance
from test_torch_kernels import one_torch_thread  # noqa: F401


def single_zero(H, W, at=(0, 0)):
    m = np.ones((H, W), np.uint8)
    m[at] = 0
    return m


def test_f3_mask_equals_tpuva_and_the_plain_loop():
    m = single_zero(4096, 94)
    sq, passes = distance.edt_model(m)
    ref, ref_passes = distance.edt_sq_passes_plain(torch.from_numpy(m))
    np.testing.assert_array_equal(sq, ref.numpy())
    assert passes == ref_passes == (4096, 94)
    np.testing.assert_array_equal(sq, np.asarray(jops.distance_transform_edt_sq(m)))
    assert sq[4095, 93] == np.float32(16_777_672) != np.float32(4095**2 + 93**2)
    assert sq[4095, 93] != 4095**2 + 93**2


def test_f_table_is_the_float32_chain():
    f = distance.f_table(6000)
    assert f.dtype == np.float32
    chain = np.zeros(6000, np.float32)
    for d in range(1, 6000):
        chain[d] = np.float32(chain[d - 1] + np.float32(2 * d - 1))
    np.testing.assert_array_equal(f, chain)
    d = np.arange(4097, dtype=np.int64)
    np.testing.assert_array_equal(f[:4097], (d * d).astype(np.float32))
    assert (f[:4097].astype(np.int64) == d * d).all()
    assert f[4097] == 16_785_408 != 4097**2  # 2^24 + 8193 rounds to even


def test_device_f_table_is_uploaded_once_a_height():
    """KE's table on a device: f_table(H), one tensor a (height, device)."""
    t = distance.device_f_table(5000, torch.device("cpu"))
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), distance.f_table(5000))
    assert distance.device_f_table(5000, torch.device("cpu")) is t
    assert distance.device_f_table(4999, torch.device("cpu")).shape == (4999,)


@pytest.mark.parametrize("shape,zeros", [
    ((1, 5000), [(0, 0)]),
    ((1, 5000), [(0, 4999)]),
    ((1, 9000), [(0, 0), (0, 8999)]),
    ((5000, 3), [(0, 1)]),
    ((5000, 3), [(0, 0), (200, 2)]),
    ((4100, 8), [(0, 3), (3, 7)]),
    ((2, 4098, 2), [(0, 0, 0), (1, 4097, 1)]),
])
def test_model_equals_plain_past_4096(shape, zeros):
    m = np.ones(shape, np.uint8)
    for z in zeros:
        m[z] = 0
    sq, passes = distance.edt_model(m)
    ref, ref_passes = distance.edt_sq_passes_plain(torch.from_numpy(m))
    np.testing.assert_array_equal(sq, ref.numpy())
    assert passes == ref_passes
    finite = sq[np.isfinite(sq)]
    assert finite.max() >= 2**24  # the sums do pass 2^24


def test_row_loop_is_the_plain_row_stage():
    """row_loop, the flagged rows' loop, equals the plain loop's row stage
    on rows of column values near 2^24, with its last changing pass."""
    rng = np.random.default_rng(5)
    g = distance.f_table(6000)[rng.integers(3000, 6000, (3, 700))]
    g[rng.random(g.shape) < 0.3] = np.inf
    got, last = distance.row_loop(g)
    ref, passes = distance.edt_pass_axis(torch.from_numpy(g), 1)
    np.testing.assert_array_equal(got, ref.numpy())
    assert last + 1 == passes
