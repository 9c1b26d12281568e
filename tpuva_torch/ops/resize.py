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
intermediate rounded as the plain version's is. KR takes a 64 x 16 output
tile (``KR_TILE``) across the images, stages the tile's distinct input
rows over the span of columns its taps name into shared memory, or, where
that footprint exceeds a buffer, gathers from global memory: a route a
tile. ``resize_plan`` is that launch, computed here as the kernel computes
it (the buffer, the routes, the CTAs over the images);
``resize_linear_routes`` counts the routes on the card. The taps and the
blocks' records go to the card once a (size, size, device)
(``device_taps``, ``device_blocks``). CPU tensors take the plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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
    KR reads it, nothing writes it (m == n: the identity, which KR skips)."""
    return torch.from_numpy(tap_table(m, n)).to(device)


KR_TILE = (64, 16)  # KR's output tile (w, h): a CTA (csrc/filters.cu kResizeTX, kResizeTY)
KR_BUF_MAX = 49152  # bytes of one of KR's two staging buffers at most (kResizeBufMax)
# CTAs KR aims for over the tiles and images, 8 an SM of an H100 (at 1080p,
# 1 to 5 CTAs a tile took the same time)
KR_CTAS = 1056


@functools.lru_cache(maxsize=64)
def tile_blocks(m: int, n: int, T: int) -> np.ndarray:
    """KR's blocks of T outputs from m to n samples, one int32 array (kept
    once a shape: read only): a slot an output (its lower tap's place in
    its block's record, the upper tap's << 16), then a record a block of 1
    + 2 T words: the count of distinct taps of its outputs, those taps in
    ascending order, zeros."""
    lo, hi = (a.astype(np.int64) for a in resize_taps(m, n)[:2])
    nb = -(-n // T)
    slots = np.zeros(n, np.int64)
    recs = np.zeros((nb, 1 + 2 * T), np.int64)
    for b in range(nb):
        s = slice(b * T, min(n, (b + 1) * T))
        taps = np.unique(np.concatenate([lo[s], hi[s]]))
        recs[b, 0] = taps.size
        recs[b, 1: 1 + taps.size] = taps
        slots[s] = np.searchsorted(taps, lo[s]) | np.searchsorted(taps, hi[s]) << 16
    return np.concatenate([slots, recs.reshape(-1)]).astype(np.int32)


@functools.lru_cache(maxsize=64)
def device_blocks(m: int, n: int, T: int, device: torch.device) -> torch.Tensor:
    """tile_blocks(m, n, T) on device, uploaded once and kept."""
    return torch.from_numpy(tile_blocks(m, n, T)).to(device)


class ResizePlan(NamedTuple):
    tiles: tuple  # (blocks of columns, blocks of rows)
    rows: np.ndarray  # (blocks of rows,) distinct input rows a tile stages
    pitch: np.ndarray  # (blocks of columns,) bytes of a staged row's span
    footprint: np.ndarray  # (blocks of rows, blocks of columns) bytes of an image's rows x span
    buf: int  # bytes of a staging buffer: the largest footprint up to KR_BUF_MAX
    staged: np.ndarray  # (blocks of rows, blocks of columns) bool: the tile stages
    grid_z: int  # CTAs over the images of a tile


@functools.lru_cache(maxsize=64)
def resize_plan(N: int, H: int, W: int, px_bytes: int, size: tuple, vec_in: bool) -> ResizePlan:
    """KR's launch for N images (H, W) of px_bytes bytes a pixel to size
    (width, height), as the kernel computes it: a tile's footprint is its
    rows' count times its span's bytes (from its first column tap's first
    byte to its last one's last, widened to 16-byte bounds where the rows
    are 16-byte aligned, vec_in); a tile stages where its footprint fits
    the buffer, the largest footprint of at most KR_BUF_MAX bytes, and
    gathers from global memory where it does not. Kept once a launch
    shape: the arrays are read only."""
    w, h = (int(v) for v in size)
    tw, th = KR_TILE
    bw = tile_blocks(W, w, tw)[w:].reshape(-1, 1 + 2 * tw)
    bh = tile_blocks(H, h, th)[h:].reshape(-1, 1 + 2 * th)
    c0 = bw[:, 1].astype(np.int64)
    c1 = bw[np.arange(len(bw)), bw[:, 0]].astype(np.int64)
    a0, a1 = c0 * px_bytes, (c1 + 1) * px_bytes
    if vec_in:
        a0, a1 = a0 & ~15, (a1 + 15) & ~15
    pitch = a1 - a0
    rows = bh[:, 0].astype(np.int64)
    footprint = rows[:, None] * pitch[None, :]
    fitting = footprint[footprint <= KR_BUF_MAX]
    buf = int(-(-fitting.max() // 16) * 16) if fitting.size else 0
    tiles = (len(bw), len(bh))
    grid_z = int(min(N, 65535, max(1, -(-KR_CTAS // (tiles[0] * tiles[1])))))
    return ResizePlan(tiles, rows, pitch, footprint, buf, footprint <= buf, grid_z)


def _resize_cuda(batch: torch.Tensor, size, routes: torch.Tensor | None) -> torch.Tensor:
    """KR's launch on a CUDA batch; routes (int32[2] on the card, or None)
    receives the tiles of each route."""
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
    px = C * x.element_size()
    vec_in = (W * px) % 16 == 0 and x.data_ptr() % 16 == 0
    vec_out = (w * px) % 16 == 0 and out.data_ptr() % 16 == 0
    plan = resize_plan(N, H, W, px, (w, h), vec_in)
    tw, th = KR_TILE
    _build.launch(dev, "tpuva_resize_linear", "resize_linear kernel", x.data_ptr(),
                  out.data_ptr(), N, H, W, C, h, w, device_taps(H, h, dev).data_ptr(),
                  device_taps(W, w, dev).data_ptr(), device_blocks(H, h, th, dev).data_ptr(),
                  device_blocks(W, w, tw, dev).data_ptr(), int(x.dtype == torch.float32),
                  plan.buf, int(vec_in), int(vec_out), plan.grid_z,
                  None if routes is None else routes.data_ptr())
    resize_linear.launches += 1
    return out


def resize_linear_routes(batch: torch.Tensor, size):
    """(resize_linear of a CUDA batch, (the tiles that staged their rows in
    shared memory, the tiles that gathered from global memory)): one KR
    launch, counted in resize_linear.launches."""
    if batch.dim() not in (3, 4):
        raise ValueError("resize_linear: batch must be (N, H, W) or (N, H, W, C)")
    if batch.device.type != "cuda":
        raise ValueError(f"resize_linear_routes: a CUDA tensor is needed, got {batch.device}")
    routes = torch.zeros(2, dtype=torch.int32, device=batch.device)
    out = _resize_cuda(batch, size, routes)
    return out, tuple(routes.tolist())


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
    return _resize_cuda(batch, size, None)


resize_linear.launches = 0
