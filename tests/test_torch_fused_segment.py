"""Kernel K1's plain version (tpuva_torch.ops.fused_segment) against the
Pallas kernel tpuva.ops.pallas.fused_segment, run in interpret mode as
tests/test_pallas_fused.py runs it, on the same numpy frames.

Masks are compared bit for bit. The final background is compared bit for
bit against the pinned contract: float32 (1-a)*B + a*F with two products
and one add (refimpl/pipeline.py's numpy form), over the reference's own
filtered frames. Against the JAX result it is held to 1e-5 relative: the
XLA:CPU backend contracts that update into a fused multiply-add inside
its frame loop (fma(1-a, B, a*F), one rounding instead of two), a few
float32 ulps from the contract.

The CUDA kernel has no CPU mode: tests/test_torch_kernels.py holds it
against this plain version on a card, and chip_smoke.py at the main
path's shapes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuva.graph.config import BlurConfig, MedianConfig, PipelineConfig
from tpuva.graph.pipeline import filter_batch
from tpuva.ops.pallas.fused_segment import fused_segment as jax_fused
from tpuva_torch.ops.fused_segment import fused_segment
from test_torch_kernels import BENCH, CONFIGS, one_torch_thread, scene  # noqa: F401


def contract_bg(filtered, bg0, alpha):
    """The pinned float32 recurrence, two roundings per step."""
    a = np.float32(alpha)
    c1 = np.float32(1) - a
    bg = bg0.astype(np.float32)
    for f in filtered:
        bg = c1 * bg + a * f
    return bg


def _jax_filtered(frames, kw):
    cfg = PipelineConfig(
        blur=BlurConfig(kw["blur_ksize"], kw["blur_sigma"]),
        median=MedianConfig(3) if kw.get("median_ksize") else None,
    )
    return np.asarray(filter_batch(cfg, jnp.asarray(frames, jnp.float32)))


@pytest.mark.parametrize("shape", [(5, 64, 256), (4, 50, 100)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_matches_pallas(name, shape):
    kw = CONFIGS[name]
    frames, bg0 = scene(*shape, seed=sum(shape))
    m_ref, bg_ref = jax_fused(jnp.asarray(frames), jnp.asarray(bg0), **kw)
    masks, bg = fused_segment(torch.from_numpy(frames), torch.from_numpy(bg0), **kw)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(m_ref))
    assert masks.numpy().any()
    filtered = _jax_filtered(frames, kw)
    np.testing.assert_array_equal(bg.numpy(), contract_bg(filtered, bg0, kw["alpha"]))
    np.testing.assert_allclose(bg.numpy(), np.asarray(bg_ref), rtol=1e-5)


@pytest.mark.parametrize("name", ["bench", "median3"])
def test_seed_bg_from_filtered_first_frame(name):
    """seed_bg starts from the filtered first frame, as tpuva's
    _fused_mask_stage seeds bg0 = filter_batch(frames[:1])[0]."""
    kw = CONFIGS[name]
    frames, _ = scene(5, 64, 256, seed=3)
    filtered = _jax_filtered(frames, kw)
    m_ref, _ = jax_fused(jnp.asarray(frames), jnp.asarray(filtered[0]), **kw)
    masks, bg = fused_segment(
        torch.from_numpy(frames), torch.zeros(64, 256), seed_bg=True, **kw
    )
    np.testing.assert_array_equal(masks.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(
        bg.numpy(), contract_bg(filtered, filtered[0], kw["alpha"])
    )


def test_no_blur_no_morph_and_empty_batch():
    kw = dict(alpha=0.1, threshold=10.0)
    frames, bg0 = scene(3, 40, 70, seed=9)
    m_ref, _ = jax_fused(jnp.asarray(frames), jnp.asarray(bg0), **kw)
    masks, _ = fused_segment(torch.from_numpy(frames), torch.from_numpy(bg0), **kw)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(m_ref))
    m0, b0 = fused_segment(
        torch.zeros((0, 40, 70), dtype=torch.uint8), torch.from_numpy(bg0), **kw
    )
    assert m0.shape == (0, 40, 70)
    np.testing.assert_array_equal(b0.numpy(), bg0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    frames = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fused_segment(frames.float(), torch.zeros(8, 8), **BENCH)
    with pytest.raises(ValueError):
        fused_segment(frames, torch.zeros(8, 9), **BENCH)
    with pytest.raises(NotImplementedError):
        fused_segment(frames, torch.zeros(8, 8), median_ksize=5, **BENCH)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        fused_segment(frames.to("meta"), torch.zeros(8, 8, device="meta"), **BENCH)
