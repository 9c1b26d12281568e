"""Image filters with OpenCV semantics — port of ``tpuva/ops/filters.py``.

Plain PyTorch on ``(..., H, W)`` tensors. These are the ops the fused
front-end kernel (``ops/fused_segment.py``) is held against, and the path
CPU tensors take. Pinned semantics, as in the JAX package:

- ``gaussian_blur``: cv2's float Gaussian on float32 (``FilterBlur`` on a
  float batch): the binomial kernels (sigma <= 0, ksize 3 and 5) as tpuva's
  box cascade of adjacent-pair sums, bit-equal to it; the others as its
  REFLECT_101 correlation in cv2's symmetric-pair order, each product and
  sum rounded on its own (tpuva's XLA:CPU run contracts
  ``out + k * (a + b)`` into one FMA, ROADMAP Queue 3 R5). Kernel KG
  (``csrc/filters.cu``) on a float32 CUDA tensor, ``gaussian_blur_plain``
  on a CPU one; both take FilterBlur's colour layout (..., H, W, C)
  directly (``channels_last``).
- ``gaussian_blur_u8``: cv2's uint8 fixed-point Gaussian, bit-exact, with
  REFLECT_101 borders. The JAX op's three regimes (binomial cascade for
  k=3/5, the sigma<=0 tables for k=7/9, the ``u8_gaussian_taps``
  correlation) all equal one integer form,
  ``(sum_y t_y sum_x t_x x + 2^(s-1)) >> s`` with integer taps ``t``
  (``blur_taps``); every partial sum is below 2^24, so int32 is exact.
  No float convolution: cuDNN would run it in TF32.
- ``median_blur``: BORDER_REPLICATE; the 19-op network for k=3, the
  middle of the sorted k*k window stack for a larger k.
- ``threshold``: strict ``x > float32(thresh)`` (cv2 THRESH_BINARY).
- ``erode``/``dilate``: min/max over the structuring element, with cv2's
  constant borders: erode reads outside pixels as 255, dilate as 0.
- ``histogram_u8``: exact integer counts per image — kernel K4
  (``csrc/otsu.cu``) on a CUDA tensor, ``histogram_u8_plain`` on a CPU
  one. tpuva's bf16 one-hot matmul and its chunk padding are TPU
  workarounds and are not carried over.
- ``otsu_from_histogram``: tpuva's float32 arithmetic, with its cumulative
  sums taken in XLA:CPU's order (``_cumsum256``).

The numpy helpers ``_SMALL_GAUSSIAN``, ``_gaussian_kernel_1d_f64``,
``gaussian_kernel_1d``, ``u8_gaussian_taps``, ``is_binomial_blur`` and
``structuring_element`` are copies of the originals, pinned by
``tests/test_torch_filters.py`` and ``tests/test_torch_filter_chain.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpuva_torch import _build

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


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """Matches cv2.getGaussianKernel(ksize, sigma) for odd ksize."""
    return _gaussian_kernel_1d_f64(ksize, sigma).astype(np.float32)


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


def _reflect101_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """x padded by r on both sides of `dim` under REFLECT_101."""
    n = x.shape[dim]
    return x.index_select(dim, torch.from_numpy(reflect101_index(n, -r, n + r)).to(x.device))


def _conv_axis_int(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Integer correlation along `dim` with REFLECT_101 borders."""
    n = x.shape[dim]
    xp = _reflect101_pad(x, len(taps) // 2, dim)
    acc = None
    for k, t in enumerate(taps):
        v = xp.narrow(dim, k, n) * t
        acc = v if acc is None else acc + v
    return acc


def _conv_axis(x: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    """Float32 correlation along `dim` with REFLECT_101 borders in cv2's
    symmetric-pair order: k[r] * centre, then + k[r - i] * (left + right)
    for i = 1..r, every product and sum rounded on its own."""
    n = x.shape[dim]
    r = len(kernel) // 2
    xp = _reflect101_pad(x, r, dim)
    out = xp.narrow(dim, r, n) * float(kernel[r])
    for i in range(1, r + 1):
        out = out + float(kernel[r - i]) * (xp.narrow(dim, r - i, n) + xp.narrow(dim, r + i, n))
    return out


def _box_cascade_axis(x: torch.Tensor, ksize: int, dim: int) -> torch.Tensor:
    """Unnormalized binomial correlation along `dim` with REFLECT_101
    borders: pad by r, then 2r passes of adjacent-pair sums, each shrinking
    the axis by one (tpuva's cascade, the same sums in the same order)."""
    y = _reflect101_pad(x, ksize // 2, dim)
    for _ in range(2 * (ksize // 2)):
        L = y.shape[dim]
        y = y.narrow(dim, 0, L - 1) + y.narrow(dim, 1, L - 1)
    return y


def gaussian_blur_plain(x: torch.Tensor, ksize: int, sigma: float = 0.0,
                        channels_last: bool = False) -> torch.Tensor:
    """Kernel KG's plain version: cv2.GaussianBlur(x, (ksize, ksize),
    sigma) on float32 input x (..., H, W), or (..., H, W, C) with
    channels_last: the row (W) pass, then the column (H) pass. Binomial
    kernels (is_binomial_blur) run as the box cascade and one exact
    power-of-two scaling; the others as _conv_axis with
    gaussian_kernel_1d's taps."""
    if channels_last:
        return gaussian_blur_plain(x.movedim(-1, -3), ksize, sigma).movedim(-3, -1)
    if ksize == 1:
        return x
    if is_binomial_blur(ksize, sigma):
        x = _box_cascade_axis(x, ksize, x.dim() - 1)
        x = _box_cascade_axis(x, ksize, x.dim() - 2)
        return x * float(np.float32(2.0 ** (-2 * (ksize - 1))))
    k = gaussian_kernel_1d(ksize, sigma)
    x = _conv_axis(x, k, x.dim() - 1)
    return _conv_axis(x, k, x.dim() - 2)


# bytes of shared memory a CTA can have on an H100 (227 KB), and the most
# KG's plan gives a tile while a smaller one fits (four CTAs an SM)
KG_SMEM_MAX = 232448
KG_SMEM_TARGET = 49152
# KG's tiles (rows, columns), largest first
KG_TILES = ((32, 64), (16, 64), (8, 64), (8, 32), (4, 32), (2, 32), (1, 32))


class BlurPlan(NamedTuple):
    th: int  # output rows a CTA (0 on the direct route)
    tw: int  # output columns a CTA
    smem: int  # dynamic shared memory bytes a CTA (0: the direct route)


def blur_float_plan(C: int, ksize: int) -> BlurPlan:
    """KG's launch for C channels and ksize taps (r = ksize // 2): a tile
    stages (th + 2r) x (tw + 2r) C inputs and (th + 2r) x tw C row-pass
    values, and the r + 1 taps, in shared memory. The first of KG_TILES
    within KG_SMEM_TARGET, else the first within KG_SMEM_MAX, else the
    direct route (the weighted taps only: ksize past ~110)."""
    r = ksize // 2
    sizes = [(th, tw, 4 * (r + 1 + (th + 2 * r) * (tw + 2 * r) * C + (th + 2 * r) * tw * C))
             for th, tw in KG_TILES]
    for limit in (KG_SMEM_TARGET, KG_SMEM_MAX):
        for th, tw, smem in sizes:
            if smem <= limit:
                return BlurPlan(th, tw, smem)
    return BlurPlan(0, 0, 0)


@functools.lru_cache(maxsize=64)
def device_blur_taps(ksize: int, sigma: float, device: torch.device) -> torch.Tensor:
    """gaussian_kernel_1d's first r + 1 taps (the centre last) on device,
    uploaded once a (ksize, sigma, device) and kept."""
    k = gaussian_kernel_1d(ksize, sigma)[: ksize // 2 + 1]
    return torch.from_numpy(np.ascontiguousarray(k)).to(device)


def _gaussian_blur_cuda(x: torch.Tensor, ksize: int, sigma: float,
                        channels_last: bool) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f"gaussian_blur: KG takes float32, got {x.dtype}")
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"gaussian_blur: ksize must be odd and positive, got {ksize}")
    if x.dim() < (3 if channels_last else 2):
        raise ValueError("gaussian_blur: x must be (..., H, W), or (..., H, W, C) channels last")
    if ksize == 1:
        return x
    C = x.shape[-1] if channels_last else 1
    if C not in (1, 3):
        raise ValueError(f"gaussian_blur: KG takes 1 or 3 channels, got {C}")
    H, W = x.shape[-3:-1] if channels_last else x.shape[-2:]
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    L = x.numel() // (H * W * C)
    r = ksize // 2
    binomial = is_binomial_blur(ksize, sigma)
    plan = blur_float_plan(C, ksize)
    taps = None if binomial else device_blur_taps(ksize, float(sigma), x.device)
    _build.launch(x.device, "tpuva_gaussian_blur_f32", "gaussian_blur kernel", x.data_ptr(),
                  out.data_ptr(), L, H, W, C, None if taps is None else taps.data_ptr(), r,
                  int(binomial), float(np.float32(2.0 ** (-2 * (ksize - 1)))), plan.th, plan.tw,
                  plan.smem)
    gaussian_blur.launches += 1
    return out


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float = 0.0,
                  channels_last: bool = False) -> torch.Tensor:
    """cv2.GaussianBlur(x, (ksize, ksize), sigma) on float32 x (..., H, W),
    or (..., H, W, C) with channels_last (FilterBlur's colour layout). A
    CUDA tensor launches kernel KG (csrc/filters.cu
    ``tpuva_gaussian_blur_f32``) once (gaussian_blur.launches counts them;
    it takes float32 and 1 or 3 channels, and ksize 1 returns x); a CPU
    tensor takes gaussian_blur_plain."""
    if x.device.type == "cpu":
        return gaussian_blur_plain(x, ksize, sigma, channels_last)
    if x.device.type != "cuda":
        raise ValueError(f"gaussian_blur: unsupported device {x.device}")
    return _gaussian_blur_cuda(x, ksize, sigma, channels_last)


gaussian_blur.launches = 0


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


# bytes of one chunk's sort in median_blur for ksize > 3: the window stack
# and the sorted values (x's element size each) and their int64 indices
MEDIAN_SORT_BYTES = 2 << 30


def median_u8_plain(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.medianBlur, BORDER_REPLICATE, for any odd ksize, as torch ops:
    kernel K7's plain version, and the path of every input K7 does not take
    (median_blur). k = 3 is the 19-op network; a larger k takes the middle
    element of the sorted k*k window stack, as tpuva's, in x's dtype. That
    stack is k*k times the input, so it is sorted over chunks of the
    leading axis that keep one sort near MEDIAN_SORT_BYTES; a uint8 input
    makes the smallest stack."""
    if ksize == 1:
        return x
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"median_blur: ksize must be odd and positive, got {ksize}")
    H, W = x.shape[-2], x.shape[-1]
    r = ksize // 2
    ri = torch.from_numpy(np.clip(np.arange(-r, H + r), 0, H - 1)).to(x.device)
    ci = torch.from_numpy(np.clip(np.arange(-r, W + r), 0, W - 1)).to(x.device)

    def windows(xp):
        return [xp[..., dy:dy + H, dx:dx + W] for dy in range(ksize) for dx in range(ksize)]

    if ksize == 3:
        return _median9(windows(x.index_select(x.ndim - 2, ri).index_select(x.ndim - 1, ci)))
    lead = x.reshape(-1, H, W)
    step = max(1, MEDIAN_SORT_BYTES // ((2 * x.element_size() + 8) * ksize * ksize * H * W))
    out = torch.empty_like(lead)
    for i in range(0, lead.shape[0], step):
        xp = lead[i:i + step].index_select(1, ri).index_select(2, ci)
        stack = torch.stack(windows(xp), dim=-1)
        out[i:i + step] = torch.sort(stack, dim=-1).values[..., ksize * ksize // 2]
    return out.reshape(x.shape)


def median_u8_counts_plain(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.medianBlur, BORDER_REPLICATE, of integer frames (..., H, W) in
    [0, 255], in memory that does not grow with k: the median is the
    number of thresholds t in 1..255 with #(window < t) <= k*k // 2, each
    count a box sum of the int32 cumulative sums of the replicate-padded
    indicator (x < t). K7's yardstick where median_u8_plain's k*k window
    stack cannot be held (k = 255 at 1080p); nothing on the main path
    calls it."""
    if ksize == 1:
        return x
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"median_blur: ksize must be odd and positive, got {ksize}")
    H, W = x.shape[-2], x.shape[-1]
    r = ksize // 2
    ri = torch.from_numpy(np.clip(np.arange(-r, H + r), 0, H - 1)).to(x.device)
    ci = torch.from_numpy(np.clip(np.arange(-r, W + r), 0, W - 1)).to(x.device)
    lead = x.reshape(-1, H, W)
    xp = lead.index_select(1, ri).index_select(2, ci)
    cs = torch.zeros((lead.shape[0], H + ksize, W + ksize), dtype=torch.int32, device=x.device)
    med = torch.zeros(lead.shape, dtype=torch.int32, device=x.device)
    k, rank = ksize, ksize * ksize // 2
    for t in range(1, 256):
        ind = (xp < t).to(torch.int32)
        cs[:, 1:, 1:] = ind.cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32)
        below = cs[:, k:, k:] - cs[:, :-k, k:] - cs[:, k:, :-k] + cs[:, :-k, :-k]
        med += (below <= rank).to(torch.int32)
    return med.to(x.dtype).reshape(x.shape)


def median_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.medianBlur, BORDER_REPLICATE, for any odd ksize, on (..., H, W).
    A uint8 tensor on the card launches kernel K7 (ops.median.median_u8),
    its leading axes folded into one; every other input (another dtype, the
    CPU) takes median_u8_plain's torch ops."""
    if x.device.type == "cuda" and x.dtype == torch.uint8 and x.dim() >= 2:
        from tpuva_torch.ops.median import median_u8

        H, W = x.shape[-2:]
        return median_u8(x.reshape(-1, H, W), ksize).reshape(x.shape)
    return median_u8_plain(x, ksize)


def threshold(x: torch.Tensor, thresh: float, maxval: float = 255.0) -> torch.Tensor:
    """cv2.THRESH_BINARY: maxval where x > float32(thresh), else 0 (uint8)."""
    thr = torch.tensor(np.float32(thresh), dtype=torch.float32)
    return torch.where(
        x > thr.to(x.device),
        torch.tensor(int(maxval), dtype=torch.uint8, device=x.device),
        torch.tensor(0, dtype=torch.uint8, device=x.device),
    )


def histogram_u8_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K4: (L, H, W) uint8 -> (L, 256) int32 counts."""
    L = x.shape[0]
    flat = x.reshape(L, -1).long()
    ones = torch.ones((), dtype=torch.int32, device=x.device).expand(flat.shape)
    return torch.zeros((L, 256), dtype=torch.int32, device=x.device).scatter_add_(1, flat, ones)


def _histogram_u8_cuda(x: torch.Tensor) -> torch.Tensor:
    L, H, W = x.shape
    if H * W >= 1 << 31 or L > 65535:
        raise ValueError("histogram kernel: H * W < 2^31 and at most 65535 images")
    hist = torch.zeros((L, 256), dtype=torch.int32, device=x.device)
    _build.launch(x.device, "tpuva_histogram_u8", "histogram kernel",
                  x.data_ptr(), L, H * W, hist.data_ptr())
    histogram_u8.launches += 1
    return hist


def histogram_u8(x: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of each uint8 image of a batch, port of tpuva's
    histogram_u8: x (..., H, W) uint8 -> (..., 256) float32 counts, bin v =
    pixel value; exact below 2^24 pixels an image.

    CUDA tensors launch kernel K4 (csrc/otsu.cu); CPU tensors take
    histogram_u8_plain. Counts are int32 in both, cast to float32 here."""
    if x.dtype != torch.uint8 or x.dim() < 2:
        raise ValueError("histogram_u8: x must be (..., H, W) uint8")
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    x3 = x.reshape((-1, H, W))
    if x3.device.type == "cpu":
        hist = histogram_u8_plain(x3)
    elif x3.device.type == "cuda":
        if x3.numel() == 0:
            hist = torch.zeros((x3.shape[0], 256), dtype=torch.int32, device=x3.device)
        else:
            hist = _histogram_u8_cuda(x3.contiguous())
    else:
        raise ValueError(f"histogram_u8: unsupported device {x.device}")
    return hist.to(torch.float32).reshape(lead + (256,))


histogram_u8.launches = 0


def _cumsum256(v: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumulative sum over the last axis (256), in the
    order XLA:CPU gives jnp.cumsum there: sequential sums inside 16 blocks
    of 16, a sequential prefix of the block totals, then block prefix +
    in-block sum. At 1080p the partial sums of tpuva's Otsu pass 2^24 and
    round, so the order decides the threshold; torch.cumsum takes another
    order (on the card a parallel scan)."""
    b = v.reshape(v.shape[:-1] + (16, 16))
    cols = [b[..., 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + b[..., j])
    within = torch.stack(cols, dim=-1)  # (..., 16 blocks, 16)
    prefix = [torch.zeros_like(within[..., 0, -1])]
    for k in range(1, 16):
        prefix.append(prefix[-1] + within[..., k - 1, -1])
    return (torch.stack(prefix, dim=-1)[..., None] + within).reshape(v.shape)


def otsu_from_histogram(hist: torch.Tensor) -> torch.Tensor:
    """Otsu threshold from a 256-bin histogram (cv2.THRESH_OTSU semantics:
    maximise the between-class variance; ties take the lowest threshold),
    tpuva's float32 arithmetic op for op. hist: (..., 256) float32 counts
    -> (...) float32 threshold."""
    total = hist.sum(-1, keepdim=True)  # integer counts: exact in any order
    bins = torch.arange(256, dtype=torch.float32, device=hist.device)
    w0 = _cumsum256(hist)
    sum0 = _cumsum256(hist * bins)
    sum_all = sum0[..., -1:]
    w1 = total - w0
    mu0 = sum0 / w0.clamp(min=1.0)
    mu1 = (sum_all - sum0) / w1.clamp(min=1.0)
    d = mu0 - mu1
    var_between = w0 * w1 * (d * d)
    valid = (w0 > 0) & (w1 > 0)
    var_between = torch.where(valid, var_between, -1.0)
    return torch.argmax(var_between, dim=-1).to(torch.float32)


def otsu_threshold(x: torch.Tensor) -> torch.Tensor:
    """Otsu threshold of each uint8 image of x (..., H, W) -> (...) float32."""
    return otsu_from_histogram(histogram_u8(x))


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


def morph_steps_plain(x: torch.Tensor, steps) -> torch.Tensor:
    """Erode and dilate steps = [(se, erode), ...] in order, each a _morph:
    the torch ops kernel K1m (ops.wide.morph_steps) is held to."""
    for se, is_erode in steps:
        x = _morph(x, se, is_erode=is_erode)
    return x


def _morph_run(x: torch.Tensor, steps) -> torch.Tensor:
    """steps on x: a uint8 (N, H, W) batch on the card launches kernel K1m
    (ops.wide.morph_steps, a launch a morph_plan group); anything else
    runs morph_steps_plain."""
    if steps and x.device.type == "cuda" and x.dtype == torch.uint8 and x.dim() == 3:
        from tpuva_torch.ops.wide import morph_steps

        return morph_steps(x, steps)
    return morph_steps_plain(x, steps)


def erode(x: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """x: uint8 (..., H, W); K1m for a uint8 (N, H, W) batch on the card."""
    return _morph_run(x, [(se, True)] * iterations)


def dilate(x: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.dilate reflects the SE about the anchor; structuring_element's
    SEs are symmetric, so the reflection is a no-op. K1m for a uint8
    (N, H, W) batch on the card."""
    return _morph_run(x, [(se, False)] * iterations)


def morph_open(x: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """Erode then dilate, `iterations` steps each: one morph_steps call on
    the card."""
    return _morph_run(x, [(se, True)] * iterations + [(se, False)] * iterations)


def morph_close(x: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """Dilate then erode, `iterations` steps each: one morph_steps call on
    the card."""
    return _morph_run(x, [(se, False)] * iterations + [(se, True)] * iterations)
