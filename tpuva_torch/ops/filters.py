"""Image filters with OpenCV semantics — port of ``tpuva/ops/filters.py``.

Plain PyTorch on ``(..., H, W)`` tensors. These are the ops the fused
front-end kernel (``ops/fused_segment.py``) is held against, and the path
CPU tensors take. Pinned semantics, as in the JAX package:

- ``gaussian_blur_u8``: cv2's uint8 fixed-point Gaussian, bit-exact, with
  REFLECT_101 borders. The JAX op's three regimes (binomial cascade for
  k=3/5, the sigma<=0 tables for k=7/9, the ``u8_gaussian_taps``
  correlation) all equal one integer form,
  ``(sum_y t_y sum_x t_x x + 2^(s-1)) >> s`` with integer taps ``t``
  (``blur_taps``); every partial sum is below 2^24, so int32 is exact.
  No float convolution: cuDNN would run it in TF32.
- ``median_blur``: k=3 only (BORDER_REPLICATE, the 19-op network).
- ``threshold``: strict ``x > float32(thresh)`` (cv2 THRESH_BINARY).
- ``erode``/``dilate``: min/max over the structuring element, with cv2's
  constant borders: erode reads outside pixels as 255, dilate as 0.

The numpy helpers ``_SMALL_GAUSSIAN``, ``_gaussian_kernel_1d_f64``,
``u8_gaussian_taps``, ``is_binomial_blur`` and ``structuring_element`` are
copies of the originals, pinned by ``tests/test_torch_filters.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# OpenCV's fixed kernels for sigma <= 0 (copy of tpuva/ops/filters.py)
_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [x / 256 for x in (4.0, 13.0, 30.0, 51.0, 60.0, 51.0, 30.0, 13.0, 4.0)],
}


def _gaussian_kernel_1d_f64(ksize: int, sigma: float) -> np.ndarray:
    """float64 kernel (the quantizer below needs full precision)."""
    assert ksize % 2 == 1 and ksize >= 1
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[ksize], np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def u8_gaussian_taps(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2's 8-bit fixed-point Gaussian taps (integers summing to 256),
    quantized by error diffusion from the outermost tap inward."""
    kern = _gaussian_kernel_1d_f64(ksize, sigma)
    r = ksize // 2
    ki = np.zeros(ksize, np.int64)
    err = 0.0
    for i in range(r):
        want = kern[i] * 256.0 + err
        q = int(np.floor(want + 0.5))
        err = want - q
        ki[i] = ki[ksize - 1 - i] = q
    ki[r] = 256 - 2 * int(ki[:r].sum())
    return ki


def is_binomial_blur(ksize: int, sigma: float) -> bool:
    """True when cv2's kernel for (ksize, sigma) is a pure binomial row
    (ksize 3 and 5 with sigma <= 0)."""
    return sigma <= 0 and ksize in (3, 5)


@functools.lru_cache(maxsize=64)
def structuring_element(shape: str, ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_RECT/MORPH_ELLIPSE, (k, k)) as bool."""
    if shape == "rect":
        return np.ones((ksize, ksize), bool)
    if shape != "ellipse":
        raise ValueError(f"unknown SE shape {shape!r}")
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    se = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        j1, j2 = 0, 0
        dy = i - r
        if abs(dy) <= r:
            if r == 0:
                dx = c
            else:
                dx = int(round(c * np.sqrt(max(0.0, (r * r - dy * dy)) * inv_r2)))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, ksize)
            se[i, j1:j2] = True
    return se


@functools.lru_cache(maxsize=64)
def blur_taps(ksize: int, sigma: float = 0.0) -> tuple[tuple[int, ...], int]:
    """(integer taps, shift s) with gaussian_blur_u8 == (conv + 2^(s-1)) >> s.

    ksize <= 1 is the identity ((1,), 0). sigma <= 0 with ksize in
    _SMALL_GAUSSIAN takes cv2's table scaled to integers (k=3,5: the
    binomial rows of the JAX cascade; k=7: /64; k=9: /256); everything
    else the u8_gaussian_taps (sum 256, s = 16)."""
    if ksize <= 1:
        return (1,), 0
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        k = np.asarray(_SMALL_GAUSSIAN[ksize], np.float64)
        b = next(b for b in range(17) if np.all(k * 2.0**b == np.floor(k * 2.0**b)))
        return tuple(int(v) for v in k * 2.0**b), 2 * b
    return tuple(int(v) for v in u8_gaussian_taps(ksize, sigma)), 16


def reflect101_index(n: int, lo: int, hi: int) -> np.ndarray:
    """Source index of positions lo..hi-1 along an axis of length n under
    REFLECT_101 (numpy/jnp pad mode 'reflect', repeated for wide pads)."""
    i = np.arange(lo, hi, dtype=np.int64)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def _conv_axis_int(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Integer correlation along `dim` with REFLECT_101 borders."""
    n = x.shape[dim]
    r = len(taps) // 2
    idx = torch.from_numpy(reflect101_index(n, -r, n + r)).to(x.device)
    xp = x.index_select(dim, idx)
    acc = None
    for k, t in enumerate(taps):
        v = xp.narrow(dim, k, n) * t
        acc = v if acc is None else acc + v
    return acc


def gaussian_blur_u8(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur on a uint8 image, bit-exact, as integer-valued
    float32 (the JAX op's return convention). x: (..., H, W) holding
    integer values in [0, 255] (any dtype)."""
    taps, s = blur_taps(ksize, sigma)
    if s == 0:
        return x.to(torch.float32)
    y = _conv_axis_int(x.to(torch.int32), taps, x.ndim - 1)
    y = _conv_axis_int(y, taps, x.ndim - 2)
    return ((y + (1 << (s - 1))) >> s).to(torch.float32)


def _median9(p):
    """Classic 19-op median-of-9 exchange network (Paeth)."""
    for i, j in [
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ]:
        a, b = p[i], p[j]
        p[i], p[j] = torch.minimum(a, b), torch.maximum(a, b)
    return p[4]


def median_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.medianBlur, BORDER_REPLICATE. Only ksize 1 and 3 are ported."""
    if ksize == 1:
        return x
    if ksize != 3:
        raise NotImplementedError("median_blur: only ksize 3 is ported")
    H, W = x.shape[-2], x.shape[-1]
    ri = torch.from_numpy(np.clip(np.arange(-1, H + 1), 0, H - 1)).to(x.device)
    ci = torch.from_numpy(np.clip(np.arange(-1, W + 1), 0, W - 1)).to(x.device)
    xp = x.index_select(x.ndim - 2, ri).index_select(x.ndim - 1, ci)
    p = [
        xp[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)
    ]
    return _median9(p)


def threshold(x: torch.Tensor, thresh: float, maxval: float = 255.0) -> torch.Tensor:
    """cv2.THRESH_BINARY: maxval where x > float32(thresh), else 0 (uint8)."""
    thr = torch.tensor(np.float32(thresh), dtype=torch.float32)
    return torch.where(
        x > thr.to(x.device),
        torch.tensor(int(maxval), dtype=torch.uint8, device=x.device),
        torch.tensor(0, dtype=torch.uint8, device=x.device),
    )


def _morph(x: torch.Tensor, se: np.ndarray, is_erode: bool) -> torch.Tensor:
    kh, kw = se.shape
    rh, rw = kh // 2, kw // 2
    H, W = x.shape[-2], x.shape[-1]
    fill = 255 if is_erode else 0
    xp = torch.full(
        x.shape[:-2] + (H + 2 * rh, W + 2 * rw), fill, dtype=x.dtype,
        device=x.device,
    )
    xp[..., rh:rh + H, rw:rw + W] = x
    red = torch.minimum if is_erode else torch.maximum
    out = None
    for dy in range(kh):
        for dx in range(kw):
            if se[dy, dx]:
                v = xp[..., dy:dy + H, dx:dx + W]
                out = v if out is None else red(out, v)
    return out


def erode(x: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """x: uint8 (..., H, W)."""
    for _ in range(iterations):
        x = _morph(x, se, is_erode=True)
    return x


def dilate(x: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.dilate reflects the SE about the anchor; structuring_element's
    SEs are symmetric, so the reflection is a no-op."""
    for _ in range(iterations):
        x = _morph(x, se, is_erode=False)
    return x


def morph_open(x: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    return dilate(erode(x, se, iterations), se, iterations)


def morph_close(x: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    return erode(dilate(x, se, iterations), se, iterations)
