"""The exact k x k median of uint8 frames — kernel K7 (``median_u8``) and
its plain version.

Replaces tpuva's ``median_blur`` (``tpuva/ops/filters.py``) for uint8
frames on the card: cv2.medianBlur's exact median with BORDER_REPLICATE,
for every odd k. tpuva runs it as jnp (a sort of the k*k window stack) on
the TPU; no Pallas kernel carries it.

- CUDA tensors launch ``csrc/median.cu`` once (a tile of 32 x 64 pixels a
  CTA, staged with its halo in shared memory up to k = 435 and read from
  global memory past it; a radix select a pixel, its window in registers
  for k <= 9). A failed build or launch raises.
- CPU tensors take the plain version, ``median_u8_plain`` (the torch ops
  of ``ops/filters.py``: the 19-op network for k = 3, the chunked sort of
  the window stack for a larger k), which the kernel is bit-equal to.

``ops.filters.median_blur`` (and through it ``filters.FilterMedian``)
routes a uint8 tensor on the card here; every other dtype keeps the torch
sort. The median route of ``graph.pipeline`` (a median k > 3) runs K1b,
then K7, then K1 without its blur and median.
"""

from __future__ import annotations

import torch

from tpuva_torch import _build
from tpuva_torch.ops.filters import median_u8_plain

__all__ = ["median_u8", "median_u8_plain"]


def median_u8(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.medianBlur of every frame of x (N, H, W) uint8 -> uint8, exact,
    BORDER_REPLICATE; ksize odd and positive (1 is the identity). CUDA
    tensors launch kernel K7 once; CPU tensors take median_u8_plain."""
    if x.dim() != 3 or x.dtype != torch.uint8:
        raise ValueError("median_u8: x must be (N, H, W) uint8")
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"median_u8: ksize must be odd and positive, got {ksize}")
    if x.device.type == "cpu":
        return median_u8_plain(x, ksize)
    if x.device.type != "cuda":
        raise ValueError(f"median_u8: unsupported device {x.device}")
    if ksize == 1 or x.numel() == 0:
        return x.clone()
    x = x.contiguous()
    N, H, W = x.shape
    out = torch.empty_like(x)
    _build.launch(x.device, "tpuva_median_u8", "median_u8 kernel", x.data_ptr(),
                  out.data_ptr(), N, H, W, ksize)
    median_u8.launches += 1
    return out


median_u8.launches = 0
