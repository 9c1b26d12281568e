"""Running-average background model — port of ``tpuva/ops/background.py``.

cv2.accumulateWeighted semantics: ``B <- (1-alpha)*B + alpha*F`` in
float32, rounded exactly as the reference rounds it: ``c1 = 1 - alpha``
in float32 on the host, then two products and one add, each its own
rounding. ``torch.lerp``, ``addcmul`` and ``add(..., alpha=)`` are avoided
on purpose: they may fuse into a single rounding and move the threshold
edge. The fused front-end kernel does the same with ``__fmul_rn`` /
``__fadd_rn``.
"""

from __future__ import annotations

import numpy as np
import torch


def background_coeffs(alpha) -> tuple[float, float]:
    """(c1, a) = (float32(1) - float32(alpha), float32(alpha)) as Python
    floats holding exact float32 values."""
    a = np.float32(alpha)
    return float(np.float32(1) - a), float(a)


def background_update(bg: torch.Tensor, frame: torch.Tensor, alpha) -> torch.Tensor:
    """One update step. bg, frame: (..., H, W) float32."""
    c1, a = background_coeffs(alpha)
    return c1 * bg + a * frame
