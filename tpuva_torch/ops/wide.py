"""K1's stages past a CTA's shared memory — kernels K1b (``blur_u8``) and
K1m (``morph_u8``, ``morph_steps``) and their plain versions.

Kernel K1 (``ops/fused_segment.py``) holds a tile's blur window and
morphology region in shared memory, so it takes at most 63 blur taps, a
structuring element at most 31 wide and a morphology reach whose tile fits
a CTA (``k1_takes``). tpuva's Pallas K1 has none of these limits. For
options past them, ``fused_segment`` runs the blur before K1 as
``blur_u8`` and the open and close after it as ``open_close_u8``; both are
hand-written kernels (``csrc/wide.cu``) on CUDA tensors and the plain ops of
``ops/filters.py`` on CPU tensors, bit-equal to them.

- K1b: one launch, a tile a CTA with its window and row sums in shared
  memory; ``blur_plan`` (a pure function of the shapes and taps) picks the
  tile and whether the passes take __dp4a/__dp2a_lo (every tap <= 255), and
  takes the two global passes only for tap counts whose window fits no
  tile.
- K1m: ``morph_plan`` (a pure function of the shapes and steps) cuts the
  steps into groups whose summed reach fits a tile's halo, and each group
  is one launch that runs its steps in shared memory; an SE whose single
  step fits no tile takes one launch of the global one-step kernel. Every
  launch counts in ``morph_u8.launches``. On CPU tensors the steps run as
  ``_morph`` steps (``filters.morph_steps_plain``).

For K1's ``padded_occ`` mode the last K1m launch writes the padded mask and
its occupancy (``pad_to``), so that they describe the final mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpuva_torch import _build
from tpuva_torch.ops.filters import (
    blur_taps,
    gaussian_blur_u8,
    morph_steps_plain,
    structuring_element,
)

SMEM_LIMIT = 232_448  # dynamic shared memory a CTA may use on an H100
SMEM_PER_SM = 228 * 1024  # an SM's shared memory, 1 KB of it reserved per CTA
CTAS_PER_SM = 8  # 2048 threads an SM, 256 a CTA
# K1m: owned (rows, cols) per CTA, tried largest first; bytes before and
# after each buffer in shared memory; the largest ratio of a group's region
# (tile plus halo) to its tile past one step (a region of about 1.5 times
# the tile's side)
MORPH_TILES = ((128, 128), (64, 128), (64, 64), (32, 64), (32, 32), (16, 32), (16, 16))
MORPH_GUARD = 64
MORPH_HALO = 2.25
# K1b: owned columns per CTA and the rows blur_plan tries, tallest first
# (rows a multiple of the 8 a thread slides over, columns of the 16-byte
# stores)
BLUR_TILE_W = 64
BLUR_TILE_HS = (128, 64, 32, 16, 8)


def _check_batch(x: torch.Tensor, what: str) -> None:
    if x.dim() != 3 or x.dtype != torch.uint8:
        raise ValueError(f"{what}: x must be (N, H, W) uint8")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


@functools.lru_cache(maxsize=64)
def _device_ints(values: tuple, device: torch.device) -> torch.Tensor:
    """A small int32 table on the card, made once per values and device."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def _up16(v: int) -> int:
    return (v + 15) & ~15


def _ctas_per_sm(smem: int) -> int:
    return min(CTAS_PER_SM, SMEM_PER_SM // (smem + 1024))


# ---------------------------------------------------------------- K1b


def blur_smem(tile_h: int, tile_w: int, ntaps: int) -> int:
    """Dynamic shared memory of one K1b CTA (csrc/wide.cu's BlurLayout):
    the u8 window (rows of up to 15 bytes before its first column, then
    the output tile), the uint16 row sums a column a row (pitch 2 mod 4),
    the taps as ints, four and two bytes a word, and the REFLECT_101
    tables."""
    r = ntaps // 2
    WH, WW = tile_h + 2 * r, tile_w + 2 * r
    HP = WH + (6 - WH % 4) % 4
    return (_up16(WH * _up16(WW + 15)) + _up16(tile_w * HP * 2) + _up16(4 * ntaps)
            + _up16(4 * -(-ntaps // 4)) + _up16(4 * -(-ntaps // 2)) + _up16(4 * WH)
            + _up16(4 * WW))


class BlurPlan(NamedTuple):
    kernel: str  # "tiled" (one launch) or "global" (two passes over global memory)
    tile: tuple  # owned (rows, cols) per CTA; () for "global"
    grid: tuple  # CTAs (along x, along y) a frame
    smem: int  # dynamic shared memory per CTA, bytes
    dp: bool  # every tap <= 255: rows four taps an instruction (__dp4a), columns two (__dp2a_lo)


def blur_plan(H: int, W: int, taps: tuple) -> BlurPlan:
    """K1b's launch for an (H, W) image: tiles BLUR_TILE_W wide, the
    tallest of BLUR_TILE_HS whose CTA leaves an SM room for a second, else
    the tallest that fits; "global" where none fits. __dp4a and __dp2a_lo
    where every tap is at most 255. A pure function of the shapes and
    taps; it queries no card. (On an H100 at 65 taps 128 x 64 tiles beat
    256 x 32, 128 x 128 and 64 x 64 by 4-14%: PERF.md.)"""
    ntaps = len(taps)
    dp = max(taps) <= 255
    fits = [(th, blur_smem(th, BLUR_TILE_W, ntaps)) for th in BLUR_TILE_HS]
    fits = [(th, smem) for th, smem in fits if smem <= SMEM_LIMIT]
    if not fits:
        return BlurPlan("global", (), (-(-W // 256), H), 0, dp)
    th, smem = next(((th, smem) for th, smem in fits if _ctas_per_sm(smem) >= 2), fits[0])
    return BlurPlan("tiled", (th, BLUR_TILE_W), (-(-W // BLUR_TILE_W), -(-H // th)), smem, dp)


def _blur_cuda(x: torch.Tensor, taps: tuple, shift: int) -> torch.Tensor:
    """K1b on a contiguous CUDA batch for any odd count of non-negative
    integer taps whose sum times 255 fits 16 bits (blur_u8 passes cv2's;
    the tests pass asymmetric ones too), shift >= 1."""
    if sum(taps) * 255 > 0xFFFF or min(taps) < 0:
        raise ValueError("blur_u8: the row sums must fit in 16 bits")
    N, H, W = x.shape
    plan = blur_plan(H, W, taps)
    out = torch.empty_like(x)
    dev_taps = _device_ints(tuple(taps), x.device)
    if plan.kernel == "tiled":
        _build.launch(x.device, "tpuva_blur_u8", "blur_u8 kernel", x.data_ptr(), out.data_ptr(),
                      N, H, W, dev_taps.data_ptr(), len(taps), shift, *plan.tile, int(plan.dp),
                      plan.smem)
    else:
        rows = torch.empty((N, H, W), dtype=torch.int16, device=x.device)  # uint16 sums
        _build.launch(x.device, "tpuva_blur_u8_global", "blur_u8 kernel", x.data_ptr(),
                      rows.data_ptr(), out.data_ptr(), N, H, W, dev_taps.data_ptr(), len(taps),
                      shift)
    blur_u8.launches += 1
    return out


def blur_u8(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur of every frame of x (N, H, W) uint8 -> uint8, as
    gaussian_blur_u8 (REFLECT_101, cv2's integer taps). CUDA tensors launch
    kernel K1b once (blur_plan); CPU tensors take gaussian_blur_u8."""
    _check_batch(x, "blur_u8")
    taps, shift = blur_taps(ksize, sigma)
    if x.device.type == "cpu":
        return gaussian_blur_u8(x, ksize, sigma).to(torch.uint8)
    if shift == 0 or x.numel() == 0:  # ksize <= 1: the identity
        return x.clone()
    return _blur_cuda(x.contiguous(), taps, shift)


# ---------------------------------------------------------------- K1m


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


class MorphStep(NamedTuple):
    ry: int  # the SE's reach: rows above or below the anchor
    rx: int  # and columns left or right of it
    table: tuple  # the kernel's form: erode, ry, rx, extents, then per extent lo, hi, ranges, [a, b]...
    extents: int  # distinct column extents (lo, hi) of the runs
    anchor: bool  # the SE holds its anchor: a step maps an all-zero image to zeros
    runs: tuple  # se_runs(se)


@functools.lru_cache(maxsize=256)
def _morph_step(se_bytes: bytes, shape: tuple, erode: bool) -> MorphStep:
    se = np.frombuffer(se_bytes, dtype=bool).reshape(shape)
    runs = se_runs(se)
    if not runs:
        raise ValueError("morph_u8: the structuring element is empty")
    trip = np.array(runs, np.int64).reshape(-1, 3)
    extents = sorted({(int(lo), int(hi)) for _dy, lo, hi in trip})
    table = [int(erode), int(np.abs(trip[:, 0]).max()), int(np.abs(trip[:, 1:]).max()),
             len(extents)]
    for lo, hi in extents:
        dys = sorted(int(dy) for dy, a, b in trip if (a, b) == (lo, hi))
        ranges = []
        for dy in dys:  # contiguous row ranges [a, b]
            if ranges and ranges[-1][1] == dy - 1:
                ranges[-1][1] = dy
            else:
                ranges.append([dy, dy])
        table += [lo, hi, len(ranges)] + [v for rg in ranges for v in rg]
    anchor = any(dy == 0 and lo <= 0 <= hi for dy, lo, hi in trip)
    return MorphStep(table[1], table[2], tuple(table), len(extents), anchor, runs)


def morph_step(se: np.ndarray, erode: bool) -> MorphStep:
    """One erode (or dilate) step with the structuring element se in the
    kernel's form."""
    se = np.ascontiguousarray(se, dtype=bool)
    return _morph_step(se.tobytes(), se.shape, bool(erode))


def morph_smem(tile_h: int, tile_w: int, Ry: int, Rx: int, nbuf: int, table_len: int) -> int:
    """Dynamic shared memory of one K1m CTA (csrc/wide.cu's morph_smem): nbuf
    buffers of the region, (tile_h + 2 Ry) rows of tile_w + 2 Rx' bytes with
    Rx rounded up to 16 as Rx', each with MORPH_GUARD bytes before and after,
    and the group's table."""
    Rxa = _up16(Rx)
    return nbuf * _up16((tile_h + 2 * Ry) * (tile_w + 2 * Rxa) + 2 * MORPH_GUARD) + _up16(
        4 * table_len)


class MorphGroup(NamedTuple):
    start: int  # steps [start, stop) of the step list
    stop: int
    kernel: str  # "tiled" (the steps in shared memory, one launch) or "step" (one step over global memory)
    tile: tuple  # owned (rows, cols) per CTA; () for "step"
    reach: tuple  # (Ry, Rx): the steps' summed reach
    nbuf: int  # region buffers: 2, or 3 where an SE has several extents
    smem: int  # dynamic shared memory per CTA, bytes
    grid: tuple  # CTAs (along x, along y) a frame
    table: tuple  # the steps' tables, concatenated
    skip: bool  # every SE holds its anchor: a CTA whose region is all zero writes zeros


def _group(H, W, infos, start, stop, tile):
    part = infos[start:stop]
    Ry, Rx = sum(s.ry for s in part), sum(s.rx for s in part)
    nbuf = 3 if any(s.extents > 1 for s in part) else 2
    table = tuple(v for s in part for v in s.table)
    th, tw = tile
    return MorphGroup(start, stop, "tiled", tile, (Ry, Rx), nbuf,
                      morph_smem(th, tw, Ry, Rx, nbuf, len(table)),
                      (-(-W // tw), -(-H // th)), table, all(s.anchor for s in part))


def _group_fits(g: MorphGroup) -> bool:
    th, tw = g.tile
    Ry, Rx = g.reach
    region = (th + 2 * Ry) * (tw + 2 * _up16(Rx))
    return g.smem <= SMEM_LIMIT and (g.stop - g.start == 1 or region <= MORPH_HALO * th * tw)


def morph_plan(H: int, W: int, steps) -> tuple:
    """K1m's launches for erode/dilate steps = [(se, erode), ...] on an
    (H, W) image: MorphGroups that cover the steps in order, each step
    once. A group takes consecutive steps while its region fits shared
    memory and, past its first step, stays within MORPH_HALO times the
    tile, with the first tile of MORPH_TILES that takes its first step; a
    step that no tile takes is a "step" group of its own. A pure function
    of the shapes and steps; it queries no card."""
    infos = [morph_step(se, erode) for se, erode in steps]
    groups, i = [], 0
    while i < len(infos):
        for tile in MORPH_TILES:
            if _group_fits(_group(H, W, infos, i, i + 1, tile)):
                j = i + 1
                while j < len(infos) and _group_fits(_group(H, W, infos, i, j + 1, tile)):
                    j += 1
                groups.append(_group(H, W, infos, i, j, tile))
                break
        else:
            s = infos[i]
            groups.append(MorphGroup(i, i + 1, "step", (), (s.ry, s.rx), 0, 0,
                                     (-(-W // 256), H), s.runs, s.anchor))
            j = i + 1
        i = j
    return tuple(groups)


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


def _morph_launch(x, out, occ, g: MorphGroup, erode: bool) -> None:
    """One launch of plan group g on contiguous tensors: x (N, H, W) into
    out (N, Hp, Wp), occ (N, Hp/2, Wp/128) or None; erode is the step's
    for a "step" group (a "tiled" one has its steps' in its table)."""
    N, H, W = x.shape
    Hp, Wp = out.shape[1:]
    table = _device_ints(g.table, x.device).data_ptr()
    occ_ptr = None if occ is None else occ.data_ptr()
    if g.kernel == "tiled":
        _build.launch(x.device, "tpuva_morph_u8", "morph_u8 kernel", x.data_ptr(),
                      out.data_ptr(), N, H, W, table, len(g.table), g.stop - g.start, *g.reach,
                      int(g.skip), *g.tile, g.nbuf, g.smem, Hp, Wp, occ_ptr)
    else:
        _build.launch(x.device, "tpuva_morph_step_u8", "morph_u8 kernel", x.data_ptr(),
                      out.data_ptr(), N, H, W, table, len(g.table) // 3, int(erode), Hp, Wp,
                      occ_ptr)


def morph_steps(x: torch.Tensor, steps, pad_to=None):
    """Erode and dilate steps = [(se, erode), ...] of every frame of x
    (N, H, W) uint8, in order, cv2's constant borders at every step: a
    chain of filters._morph. With pad_to = (Hp, Wp) (Hp even, Wp a multiple
    of 128) it returns pad_occ_plain's (padded mask, occupancy) of the
    result instead. CUDA tensors launch kernel K1m once a group of
    morph_plan; CPU tensors run the steps as _morph steps
    (morph_steps_plain)."""
    _check_batch(x, "morph_u8")
    N, H, W = x.shape
    if pad_to is not None and (pad_to[0] < H or pad_to[1] < W or pad_to[0] % 2
                               or pad_to[1] % 128):
        raise ValueError(f"morph_u8: cannot pad ({H}, {W}) to {pad_to}")
    steps = [(np.asarray(se, bool), bool(erode)) for se, erode in steps]
    if not steps:
        raise ValueError("morph_u8: no step")
    plan = morph_plan(H, W, steps)
    if x.device.type == "cpu" or x.numel() == 0:
        x = morph_steps_plain(x, steps)
        return x if pad_to is None else pad_occ_plain(x, pad_to)
    x = x.contiguous()
    occ = None
    for k, g in enumerate(plan):
        last = pad_to is not None and k == len(plan) - 1
        Hp, Wp = pad_to if last else (H, W)
        out = torch.empty((N, Hp, Wp), dtype=torch.uint8, device=x.device)
        if last:
            occ = torch.empty((N, Hp // 2, Wp // 128), dtype=torch.uint8, device=x.device)
        _morph_launch(x, out, occ if last else None, g, steps[g.start][1])
        morph_u8.launches += 1
        x = out
    return x if pad_to is None else (x, occ)


def morph_u8(x: torch.Tensor, se: np.ndarray, erode: bool, pad_to=None):
    """One erode (or dilate) step of every frame of x (N, H, W) uint8 with
    the structuring element se, cv2's constant borders: filters._morph, as
    morph_steps with one step. morph_u8.launches counts every K1m launch,
    morph_steps' included."""
    return morph_steps(x, [(se, erode)], pad_to=pad_to)


def open_close_steps(stages) -> list:
    """The open then close of fused_segment's options as (se, erode) steps:
    stages (shape, ksize, iterations) for open and close, ksize 0 = off;
    the open erodes then dilates, the close dilates then erodes, each
    `iterations` steps (filters.morph_open, morph_close)."""
    steps = []
    for (shape, ksize, iters), first_erode in zip(stages, (True, False)):
        if not ksize:
            continue
        se = structuring_element(shape, ksize)
        steps += [(se, erode) for erode in (first_erode, not first_erode) for _ in range(iters)]
    return steps


def open_close_u8(mask: torch.Tensor, stages, pad_to=None):
    """The open then close of fused_segment's options (open_close_steps) as
    morph_steps: one K1m launch a group of morph_plan. With pad_to the last
    launch returns the padded mask and its occupancy (morph_steps)."""
    steps = open_close_steps(stages)
    if not steps:
        if pad_to is not None:
            raise ValueError("open_close_u8: pad_to needs a morphology step to write it")
        return mask
    return morph_steps(mask, steps, pad_to=pad_to)


blur_u8.launches = 0
morph_u8.launches = 0
