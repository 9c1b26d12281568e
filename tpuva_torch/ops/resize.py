"""The linear resize of a batch (kernel KR) — the port of tpuva's
``FilterResize.batch_transform`` (``tpuva/filters.py:220``:
``jax.image.resize(..., method="linear", antialias=False)``).

``resize_taps`` are jax.image.resize's weights, computed on the host as
its ``compute_weight_mat`` computes them in float32: at most two taps an
output sample. ``resize_linear_plain`` applies them as torch ops, H then
W, each axis ``w_lo * x[lo] + w_hi * x[hi]`` with every product and sum
rounded on its own (tpuva's XLA:CPU run contracts them into FMAs: ROADMAP
Queue 3 R5), and skips an axis whose size stays, as jax does.
``resize_linear`` launches KR (csrc/filters.cu ``tpuva_resize_linear``)
once on a CUDA tensor: both passes fused, the H pass's float32
intermediate rounded as the plain version's is; the taps go to the card
once a (size, size, device) (``device_taps``). CPU tensors take the plain
version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpuva_torch import _build


@functools.lru_cache(maxsize=32)
def resize_taps(m: int, n: int) -> tuple:
    """jax.image.resize's "linear" weights (antialias off) from m to n
    samples, as its compute_weight_mat takes them in float32, each op
    rounded on its own: (lower index, upper index, their weights) per
    output sample, numpy. Each output has at most two nonzero weights;
    where it has one, the upper tap repeats the lower with weight 0."""
    f32 = np.float32
    scale = n / m
    inv = f32(1.0 / scale)
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.0) - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - dist)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
                 w / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    w = np.where(((sample >= -0.5) & (sample <= m - 0.5))[None, :], w, f32(0)).astype(f32)
    lo = np.zeros(n, np.int64)
    hi = np.zeros(n, np.int64)
    wlo = np.zeros(n, f32)
    whi = np.zeros(n, f32)
    for o in range(n):
        nz = np.flatnonzero(w[:, o])
        if nz.size > 2:
            raise AssertionError("a linear resize sample has at most two taps")
        if nz.size:
            lo[o] = hi[o] = nz[0]
            wlo[o] = w[nz[0], o]
        if nz.size == 2:
            hi[o] = nz[1]
            whi[o] = w[nz[1], o]
    return lo, hi, wlo, whi


def resize_axis_plain(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x resampled to n along dim: w_lo * x[lo] + w_hi * x[hi]."""
    lo, hi, wlo, whi = (torch.from_numpy(a).to(x.device) for a in resize_taps(x.shape[dim], n))
    shape = [1] * x.dim()
    shape[dim] = n
    return (x.index_select(dim, lo) * wlo.reshape(shape)
            + x.index_select(dim, hi) * whi.reshape(shape))


def resize_linear_plain(batch: torch.Tensor, size) -> torch.Tensor:
    """KR's plain version: batch (N, H, W[, C]) to size (width, height),
    H then W; uint8 rounded half to even and clipped, others float32."""
    w, h = size
    out = batch.to(torch.float32)
    if out.shape[1] != h:  # jax skips an axis whose size stays
        out = resize_axis_plain(out, 1, h)
    if out.shape[2] != w:
        out = resize_axis_plain(out, 2, w)
    if batch.dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out


def tap_table(m: int, n: int) -> np.ndarray:
    """KR's taps from m to n samples as one (4, n) int32 table: the lower
    and upper indices, then the bits of their float32 weights."""
    lo, hi, wlo, whi = resize_taps(m, n)
    return np.stack([lo.astype(np.int32), hi.astype(np.int32), wlo.view(np.int32),
                     whi.view(np.int32)])


@functools.lru_cache(maxsize=64)
def device_taps(m: int, n: int, device: torch.device) -> torch.Tensor:
    """tap_table(m, n) on device, uploaded once a (m, n, device) and kept:
    KR reads it, nothing writes it."""
    return torch.from_numpy(tap_table(m, n)).to(device)


def resize_linear(batch: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of batch (N, H, W) or (N, H, W, C) to size (width,
    height): jax.image.resize "linear" without antialiasing. uint8 in,
    uint8 out; any other dtype float32 out. CUDA tensors launch KR once
    (resize_linear.launches counts them; C must be 3 there, another dtype
    than uint8 and float32 is cast to float32 first); CPU tensors take
    resize_linear_plain."""
    if batch.dim() not in (3, 4):
        raise ValueError("resize_linear: batch must be (N, H, W) or (N, H, W, C)")
    if batch.device.type == "cpu":
        return resize_linear_plain(batch, size)
    if batch.device.type != "cuda":
        raise ValueError(f"resize_linear: unsupported device {batch.device}")
    C = batch.shape[3] if batch.dim() == 4 else 1
    if batch.dim() == 4 and C != 3:
        raise ValueError(f"resize_linear: KR takes 1 or 3 channels, got {C}")
    w, h = (int(v) for v in size)
    x = batch if batch.dtype in (torch.uint8, torch.float32) else batch.to(torch.float32)
    x = x.contiguous()
    N, H, W = x.shape[:3]
    out = torch.empty((N, h, w) + x.shape[3:], dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if x.numel() == 0:
        raise ValueError("resize_linear: an empty frame has nothing to sample")
    dev = x.device
    taps_h = device_taps(H, h, dev) if h != H else None
    taps_w = device_taps(W, w, dev) if w != W else None
    _build.launch(dev, "tpuva_resize_linear", "resize_linear kernel", x.data_ptr(),
                  out.data_ptr(), N, H, W, C, h, w,
                  None if taps_h is None else taps_h.data_ptr(),
                  None if taps_w is None else taps_w.data_ptr(),
                  int(x.dtype == torch.float32))
    resize_linear.launches += 1
    return out


resize_linear.launches = 0
