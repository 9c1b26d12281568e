"""Fused segmentation front-end — kernel K1 and its plain version.

Replaces the Pallas kernel ``tpuva/ops/pallas/fused_segment.py::
fused_segment`` (``emit="mask"``, without ``padded_occ``). Per frame:
u8 Gaussian blur (REFLECT_101) -> optional median 3x3 (REPLICATE) ->
``B <- (1-a)B + aF`` (float32) -> ``|F - B| > thr`` -> open -> close
(cv2 constant borders).

- CUDA tensors launch ``csrc/fused_segment.cu``: one CTA per spatial tile
  walks the N frames in order with the tile's background in shared
  memory (see the source for the design and what bounds it).
- CPU tensors take the plain version, ``fused_segment_plain``: the op
  chain of tpuva's ``process_batch`` jnp branch (graph/pipeline.py).

``seed_bg=True`` starts the background from the filtered (blur, median)
first frame instead of ``bg0`` — the pipeline's first batch without a
background plate — so seeding runs through the kernel too.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuva_torch import _build
from tpuva_torch.ops.background import background_coeffs, background_update
from tpuva_torch.ops.filters import (
    blur_taps,
    gaussian_blur_u8,
    median_blur,
    morph_close,
    morph_open,
    structuring_element,
    threshold as threshold_op,
)

# limits of csrc/fused_segment.cu's parameter block
MAX_TAPS = 63
MAX_SE = 31
TILE = (32, 64)  # owned (rows, cols) per CTA


def fused_segment_plain(
    frames: torch.Tensor,
    bg0: torch.Tensor,
    *,
    alpha: float,
    threshold: float,
    blur_ksize: int = 0,
    blur_sigma: float = 0.0,
    median_ksize: int = 0,
    open_shape: str = "rect",
    open_ksize: int = 0,
    open_iters: int = 1,
    close_shape: str = "rect",
    close_ksize: int = 0,
    close_iters: int = 1,
    seed_bg: bool = False,
):
    """Plain PyTorch version of the kernel (same arguments, same results;
    N >= 1)."""
    f = gaussian_blur_u8(frames, blur_ksize, blur_sigma) if blur_ksize else frames.to(torch.float32)
    if median_ksize:
        f = median_blur(f, median_ksize)
    N, H, W = frames.shape
    bg = f[0] if seed_bg else bg0
    masks = torch.empty((N, H, W), dtype=torch.uint8, device=frames.device)
    for t in range(N):
        bg = background_update(bg, f[t], alpha)
        masks[t] = threshold_op((f[t] - bg).abs(), threshold)
    if open_ksize:
        masks = morph_open(masks, structuring_element(open_shape, open_ksize), open_iters)
    if close_ksize:
        masks = morph_close(masks, structuring_element(close_shape, close_ksize), close_iters)
    return masks, bg


def _se_rows(shape: str, ksize: int) -> list[int]:
    """SE as one bitmask per row (bit dx set where se[dy, dx])."""
    se = structuring_element(shape, ksize)
    return [int(sum(1 << dx for dx in range(ksize) if se[dy, dx])) for dy in range(ksize)]


def fused_segment(
    frames: torch.Tensor,
    bg0: torch.Tensor,
    *,
    alpha: float,
    threshold: float,
    blur_ksize: int = 0,
    blur_sigma: float = 0.0,
    median_ksize: int = 0,
    open_shape: str = "rect",
    open_ksize: int = 0,
    open_iters: int = 1,
    close_shape: str = "rect",
    close_ksize: int = 0,
    close_iters: int = 1,
    seed_bg: bool = False,
):
    """frames (N, H, W) uint8, bg0 (H, W) float32 -> (masks (N, H, W)
    uint8 0/255, final background (H, W) float32).

    blur_ksize 0 = no blur; median_ksize 0 or 3; open/close ksize 0 = off.
    CPU tensors run fused_segment_plain; CUDA tensors launch the kernel."""
    kw = dict(
        alpha=alpha, threshold=threshold, blur_ksize=blur_ksize,
        blur_sigma=blur_sigma, median_ksize=median_ksize,
        open_shape=open_shape, open_ksize=open_ksize, open_iters=open_iters,
        close_shape=close_shape, close_ksize=close_ksize,
        close_iters=close_iters, seed_bg=seed_bg,
    )
    if frames.dim() != 3 or frames.dtype != torch.uint8:
        raise ValueError("fused_segment: frames must be (N, H, W) uint8")
    N, H, W = frames.shape
    if bg0.shape != (H, W) or bg0.dtype != torch.float32 or bg0.device != frames.device:
        raise ValueError("fused_segment: bg0 must be (H, W) float32 on the frames' device")
    if median_ksize not in (0, 3):
        raise NotImplementedError("fused_segment: median_ksize must be 0 or 3")
    if N == 0:
        return torch.empty_like(frames), bg0.clone()
    if frames.device.type == "cpu":
        return fused_segment_plain(frames, bg0, **kw)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_segment: unsupported device {frames.device}")
    return _fused_segment_cuda(frames.contiguous(), bg0.contiguous(), **kw)


def _fused_segment_cuda(frames, bg0, *, alpha, threshold, blur_ksize, blur_sigma,
                        median_ksize, open_shape, open_ksize, open_iters,
                        close_shape, close_ksize, close_iters, seed_bg):
    N, H, W = frames.shape
    taps, shift = blur_taps(blur_ksize, blur_sigma) if blur_ksize else ((1,), 0)
    stages = [  # erode+dilate (open), then dilate+erode (close)
        (open_shape, open_ksize, open_iters), (open_shape, open_ksize, open_iters),
        (close_shape, close_ksize, close_iters), (close_shape, close_ksize, close_iters),
    ]
    if len(taps) > MAX_TAPS or max(k for _, k, _ in stages) > MAX_SE:
        raise ValueError(
            f"fused_segment kernel: blur ksize <= {MAX_TAPS} and morphology "
            f"ksize <= {MAX_SE}"
        )
    stage_k = np.array([k for _, k, _ in stages], np.int32)
    stage_iters = np.array([it if k else 0 for _, k, it in stages], np.int32)
    stage_se = np.zeros((4, MAX_SE), np.uint32)
    for s, (shape, k, _) in enumerate(stages):
        if k:
            stage_se[s, :k] = _se_rows(shape, k)
    taps_np = np.array(taps, np.int32)
    c1, a = background_coeffs(alpha)
    masks = torch.empty((N, H, W), dtype=torch.uint8, device=frames.device)
    bg_out = torch.empty((H, W), dtype=torch.float32, device=frames.device)
    lib = _build.load()
    err = lib.tpuva_fused_segment(
        frames.data_ptr(), bg0.data_ptr(), masks.data_ptr(), bg_out.data_ptr(),
        N, H, W, c1, a, float(np.float32(threshold)),
        taps_np.ctypes.data, len(taps), shift, 1 if median_ksize else 0,
        stage_k.ctypes.data, stage_iters.ctypes.data, stage_se.ctypes.data,
        1 if seed_bg else 0, TILE[0], TILE[1],
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _build.check(lib, err, "fused_segment kernel")
    fused_segment.launches += 1
    return masks, bg_out


fused_segment.launches = 0
