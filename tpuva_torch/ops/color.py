"""BGR -> gray of a batch (kernel KM) — the port of tpuva's
``FilterMonochrome.batch_transform`` (``tpuva/filters.py:202``, a float32
tensordot with OpenCV's BGR weights).

``bgr_to_gray`` launches KM (csrc/filters.cu ``tpuva_bgr2gray``) once on a
CUDA tensor and takes ``bgr_to_gray_plain`` on a CPU one. Both compute
(b w0 + g w1) + r w2 in float32, every product and sum rounded on its own
(tpuva's XLA:CPU run contracts them into FMAs: ROADMAP Queue 3 R5), then
uint8 is rounded half to even and clamped; a float batch stays float32.
``mono_plan`` splits the pixels between KM's 16-byte pieces and its pixel
a thread path (tails, unaligned ring slots).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuva_torch import _build

# BGR -> gray weights (OpenCV convention: x is BGR channel order)
BGR_WEIGHTS = np.array([0.114, 0.587, 0.299], np.float32)
# KM: pixels in one 16-byte piece of output (48 bytes of input), by dtype
PIECE_PX = {torch.uint8: 16, torch.float32: 4}
KM_THREADS = 256


def bgr_to_gray_plain(batch: torch.Tensor) -> torch.Tensor:
    """KM's plain version: batch (..., 3) BGR -> (...), torch ops, a channel
    at a time (4 B a pixel of temporaries)."""
    w = [float(v) for v in BGR_WEIGHTS]
    gray = batch[..., 0].to(torch.float32) * w[0]
    gray += batch[..., 1].to(torch.float32) * w[1]
    gray += batch[..., 2].to(torch.float32) * w[2]
    if batch.dtype == torch.uint8:
        return gray.round_().clamp_(0, 255).to(torch.uint8)
    return gray


class MonoPlan(NamedTuple):
    pieces: int  # whole 16-byte output pieces on KM's vector path
    start: int  # the first pixel of the pixel-a-thread path (to P)
    vec_blocks: int
    px_blocks: int


def mono_plan(P: int, per: int, aligned: bool, threads: int = KM_THREADS) -> MonoPlan:
    """KM's launch for P pixels with per pixels a piece: where input and
    output are 16-byte aligned, the whole pieces on the vector path and
    the last P % per pixels a thread each; otherwise every pixel a thread
    each. One thread a piece or pixel (the kernels stride past a grid)."""
    pieces = P // per if aligned else 0
    start = pieces * per
    return MonoPlan(pieces, start, -(-pieces // threads), -(-(P - start) // threads))


def bgr_to_gray(batch: torch.Tensor) -> torch.Tensor:
    """batch (..., 3) BGR -> gray (...): uint8 in, uint8 out; any other
    dtype float32 out. CUDA tensors launch KM once (bgr_to_gray.launches
    counts them; another dtype than uint8 and float32 is cast to float32
    first); CPU tensors take bgr_to_gray_plain."""
    if batch.dim() < 1 or batch.shape[-1] != 3:
        raise ValueError("bgr_to_gray: batch must be (..., 3) BGR")
    if batch.device.type == "cpu":
        return bgr_to_gray_plain(batch)
    if batch.device.type != "cuda":
        raise ValueError(f"bgr_to_gray: unsupported device {batch.device}")
    x = batch if batch.dtype in PIECE_PX else batch.to(torch.float32)
    x = x.contiguous()
    out = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    P = out.numel()
    if P == 0:
        return out
    plan = mono_plan(P, PIECE_PX[x.dtype], x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _build.launch(x.device, "tpuva_bgr2gray", "bgr_to_gray kernel", x.data_ptr(),
                  out.data_ptr(), P, plan.pieces, plan.start, int(x.dtype == torch.float32),
                  *(float(v) for v in BGR_WEIGHTS), plan.vec_blocks, plan.px_blocks)
    bgr_to_gray.launches += 1
    return out


bgr_to_gray.launches = 0
