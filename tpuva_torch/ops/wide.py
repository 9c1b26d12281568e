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
For K1's ``padded_occ`` mode the last K1m step writes the padded mask and
its occupancy (``pad_to``), so that they describe the final mask.
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


def occ128_plain(padded: torch.Tensor) -> torch.Tensor:
    """(N, Hp, Wp) uint8 mask, Hp even, Wp a multiple of 128 -> (N, Hp/2,
    Wp/128) uint8: 1 where the 2-row x 128-column block holds foreground
    (K1's padded_occ occupancy)."""
    N, Hp, Wp = padded.shape
    blocks = (padded != 0).reshape(N, Hp // 2, 2, Wp // 128, 128)
    return blocks.any(dim=4).any(dim=2).to(torch.uint8)


def pad_occ_plain(mask: torch.Tensor, pad_to: tuple) -> tuple:
    """(N, H, W) mask -> (the mask zero-padded to pad_to = (Hp, Wp), its
    occ128_plain): K1's padded_occ outputs from a cropped mask."""
    N, H, W = mask.shape
    padded = torch.zeros((N, *pad_to), dtype=mask.dtype, device=mask.device)
    padded[:, :H, :W] = mask
    return padded, occ128_plain(padded)


def morph_u8(x: torch.Tensor, se: np.ndarray, erode: bool, pad_to=None):
    """One erode (or dilate) step of every frame of x (N, H, W) uint8 with
    the structuring element se, cv2's constant borders: filters._morph.
    With pad_to = (Hp, Wp) (Hp even, Wp a multiple of 128) it returns
    pad_occ_plain's (padded mask, occupancy) of the result instead. CUDA
    tensors launch kernel K1m; CPU tensors take _morph."""
    _check_batch(x, "morph_u8")
    se = np.asarray(se, bool)
    N, H, W = x.shape
    if pad_to is not None and (pad_to[0] < H or pad_to[1] < W or pad_to[0] % 2
                               or pad_to[1] % 128):
        raise ValueError(f"morph_u8: cannot pad ({H}, {W}) to {pad_to}")
    if x.device.type == "cpu" or x.numel() == 0:
        out = _morph(x, se, is_erode=erode)
        return out if pad_to is None else pad_occ_plain(out, pad_to)
    runs = se_runs(se)
    if not runs:
        raise ValueError("morph_u8: the structuring element is empty")
    x = x.contiguous()
    Hp, Wp = (H, W) if pad_to is None else pad_to
    out = torch.empty((N, Hp, Wp), dtype=torch.uint8, device=x.device)
    occ = None if pad_to is None else torch.empty((N, Hp // 2, Wp // 128), dtype=torch.uint8,
                                                  device=x.device)
    lib = _build.load()
    err = lib.tpuva_morph_u8(
        x.data_ptr(), out.data_ptr(), N, H, W,
        _device_ints(runs, x.device).data_ptr(), len(runs) // 3, int(erode),
        Hp, Wp, None if occ is None else occ.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "morph_u8 kernel")
    morph_u8.launches += 1
    return out if occ is None else (out, occ)


def open_close_u8(mask: torch.Tensor, stages, pad_to=None):
    """The open then close of fused_segment's options as morph_u8 steps:
    stages (shape, ksize, iterations) for open and close, ksize 0 = off;
    the open erodes then dilates, the close dilates then erodes, each
    `iterations` steps (filters.morph_open, morph_close). With pad_to the
    last step returns the padded mask and its occupancy (morph_u8)."""
    steps = []
    for (shape, ksize, iters), first_erode in zip(stages, (True, False)):
        if not ksize:
            continue
        se = structuring_element(shape, ksize)
        steps += [(se, erode) for erode in (first_erode, not first_erode) for _ in range(iters)]
    if not steps:
        if pad_to is not None:
            raise ValueError("open_close_u8: pad_to needs a morphology step to write it")
        return mask
    for se, erode in steps[:-1]:
        mask = morph_u8(mask, se, erode)
    return morph_u8(mask, *steps[-1], pad_to=pad_to)


blur_u8.launches = 0
morph_u8.launches = 0
