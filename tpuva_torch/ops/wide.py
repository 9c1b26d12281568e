"""K1's stages past a CTA's shared memory — kernels K1b (``blur_u8``) and
K1m (``morph_u8``) and their plain versions.

Kernel K1 (``ops/fused_segment.py``) holds a tile's blur window and
morphology region in shared memory, so it takes at most 63 blur taps, a
structuring element at most 31 wide and a morphology reach whose tile fits
a CTA (``k1_takes``). tpuva's Pallas K1 has none of these limits. For
options past them, ``fused_segment`` runs the blur before K1 as
``blur_u8`` and the open and close after it as ``morph_u8`` steps; both are
hand-written kernels over global memory (``csrc/wide.cu``) on CUDA tensors
and the plain ops of ``ops/filters.py`` on CPU tensors, bit-equal to them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpuva_torch import _build
from tpuva_torch.ops.filters import _morph, blur_taps, gaussian_blur_u8, structuring_element


def _check_batch(x: torch.Tensor, what: str) -> None:
    if x.dim() != 3 or x.dtype != torch.uint8:
        raise ValueError(f"{what}: x must be (N, H, W) uint8")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


@functools.lru_cache(maxsize=64)
def _device_ints(values: tuple, device: torch.device) -> torch.Tensor:
    """A small int32 table on the card, made once per values and device."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def blur_u8(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur of every frame of x (N, H, W) uint8 -> uint8, as
    gaussian_blur_u8 (REFLECT_101, cv2's integer taps). CUDA tensors launch
    kernel K1b (two passes, rows then columns, any tap count); CPU tensors
    take gaussian_blur_u8."""
    _check_batch(x, "blur_u8")
    taps, shift = blur_taps(ksize, sigma)
    if x.device.type == "cpu":
        return gaussian_blur_u8(x, ksize, sigma).to(torch.uint8)
    if shift == 0 or x.numel() == 0:  # ksize <= 1: the identity
        return x.clone()
    if sum(taps) * 255 > 0xFFFF:
        raise ValueError("blur_u8: the row sums must fit in 16 bits")
    N, H, W = x.shape
    x = x.contiguous()
    rows = torch.empty((N, H, W), dtype=torch.int16, device=x.device)  # uint16 sums
    out = torch.empty_like(x)
    lib = _build.load()
    err = lib.tpuva_blur_u8(
        x.data_ptr(), rows.data_ptr(), out.data_ptr(), N, H, W,
        _device_ints(taps, x.device).data_ptr(), len(taps), shift,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "blur_u8 kernel")
    blur_u8.launches += 1
    return out


def se_runs(se: np.ndarray) -> tuple:
    """The structuring element as runs, flattened (dy, lo, hi) triples from
    its anchor, the centre: the pixels (dy, lo..hi) of each maximal
    horizontal stretch of set pixels, row by row (one run a row for cv2's
    rect and ellipse). The kernel's form of the SE."""
    kh, kw = se.shape
    runs = []
    for dy in range(kh):
        row = np.concatenate([[False], se[dy], [False]]).astype(np.int8)
        starts, ends = np.nonzero(np.diff(row) == 1)[0], np.nonzero(np.diff(row) == -1)[0]
        runs += [v for a, b in zip(starts, ends)
                 for v in (dy - kh // 2, int(a) - kw // 2, int(b) - 1 - kw // 2)]
    return tuple(runs)


def morph_u8(x: torch.Tensor, se: np.ndarray, erode: bool) -> torch.Tensor:
    """One erode (or dilate) step of every frame of x (N, H, W) uint8 with
    the structuring element se, cv2's constant borders: filters._morph.
    CUDA tensors launch kernel K1m; CPU tensors take _morph."""
    _check_batch(x, "morph_u8")
    se = np.asarray(se, bool)
    if x.device.type == "cpu" or x.numel() == 0:
        return _morph(x, se, is_erode=erode)
    N, H, W = x.shape
    runs = se_runs(se)
    if not runs:
        raise ValueError("morph_u8: the structuring element is empty")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = _build.load()
    err = lib.tpuva_morph_u8(
        x.data_ptr(), out.data_ptr(), N, H, W,
        _device_ints(runs, x.device).data_ptr(), len(runs) // 3, int(erode),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "morph_u8 kernel")
    morph_u8.launches += 1
    return out


def open_close_u8(mask: torch.Tensor, stages) -> torch.Tensor:
    """The open then close of fused_segment's options as morph_u8 steps:
    stages (shape, ksize, iterations) for open and close, ksize 0 = off;
    the open erodes then dilates, the close dilates then erodes, each
    `iterations` steps (filters.morph_open, morph_close)."""
    for (shape, ksize, iters), first_erode in zip(stages, (True, False)):
        if not ksize:
            continue
        se = structuring_element(shape, ksize)
        for erode in (first_erode, not first_erode):
            for _ in range(iters):
                mask = morph_u8(mask, se, erode)
    return mask


blur_u8.launches = 0
morph_u8.launches = 0
