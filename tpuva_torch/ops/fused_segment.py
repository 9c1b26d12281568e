"""Fused segmentation front-end — kernel K1 and its plain version.

Replaces the Pallas kernel ``tpuva/ops/pallas/fused_segment.py::
fused_segment``, both emits and ``padded_occ``. Per frame: u8 Gaussian blur
(REFLECT_101) -> optional median 3x3 (REPLICATE) -> ``B <- (1-a)B + aF``
(float32), then by ``emit``:

- ``"mask"``: ``|F - B| > thr`` -> open -> close (cv2 constant borders);
- ``"diff"``: ``clip(rint(|F - B|), 0, 255)`` as uint8, no threshold and
  no morphology — the Otsu routes' front end, whose threshold is a
  per-frame statistic of these magnitudes.

- CUDA tensors launch ``csrc/fused_segment.cu``: one CTA per spatial tile
  walks the N frames in order with the tile's background in registers or
  shared memory, the next frame's window copied in while a frame computes
  (see the source for the design and what bounds it). The tile and the
  kernel's instantiation come from ``launch_plan``, a pure function of the
  shapes and options, fed the card's occupancy for each candidate
  (``card_blocks_per_sm``).
- One launch takes at most 63 blur taps, structuring elements at most 31
  wide and a morphology reach whose tile fits a CTA's shared memory
  (``k1_takes``, the one place that says so). Past that, ``k1_split``
  takes the blur, the open and close, or both out of the launch:
  ``ops.wide.blur_u8`` blurs the frames before K1 and ``ops.wide.
  open_close_u8`` runs the morphology after it, hand-written kernels over
  global memory, so the wrapper takes every option tpuva's Pallas kernel
  does (median 0 or 3).
- CPU tensors take the plain version, ``fused_segment_plain``: the op
  chain of tpuva's ``process_batch`` jnp branch (graph/pipeline.py).

``padded_occ=True`` (mask emit only) is the staged route's handoff to
kernel K2: the masks come back uncropped, (N, Hp, Wp) with (Hp, Wp) the
grid cover of ``fused_tile`` (a pinned copy of tpuva's), zero outside the
image, with ``occ128`` (N, Hp/2, Wp/128) uint8, 1 where a 2-row x
128-column block of the final mask holds foreground. The kernel writes
both from the tile it just computed; where ``k1_split`` takes the open and
close out of K1, the last K1m step writes them.

``seed_bg=True`` starts the background from the filtered (blur, median)
first frame instead of ``bg0`` — the pipeline's first batch without a
background plate — so seeding runs through the kernel too.

A stream axis: frames (S, N, H, W), or a sequence of S (N, H, W) batches
wherever they lie, with bg0 (S, H, W), are S independent camera streams,
each with its own background; every output then leads with (S,). One
launch takes all of them, up to MAX_STREAMS (the grid's z index is the stream,
each stream's frames read through an array of S pointers, so no batch is
stacked on the card), and ``seed_bg`` is one flag for all streams or one a
stream — an (S,) bool tensor on the frames' device, read by the kernel (a
carry's ``~bg_valid``, with no read on the host). Where ``k1_split`` takes a stage out of K1's launch, the streams
run one after another.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpuva_torch import _build
from tpuva_torch.ops.background import background_coeffs, background_update
from tpuva_torch.ops.filters import (
    blur_taps,
    gaussian_blur_u8,
    median_u8_plain,
    morph_steps_plain,
    structuring_element,
    threshold as threshold_op,
)
from tpuva_torch.ops.wide import (
    SMEM_LIMIT,
    blur_u8,
    open_close_steps,
    open_close_u8,
    pad_occ_plain,
)

# limits of csrc/fused_segment.cu's parameter block
MAX_TAPS = 63
MAX_SE = 31
# the kernel's instantiations: tap counts with unrolled loops; 0 is the
# generic one (9..63 taps)
UNROLLED_TAPS = (1, 3, 5, 7)
# owned (rows, cols) per CTA that launch_plan weighs; the kernel takes
# widths 32, 64 and 128 (its output stores split a row over the threads)
TILES = ((64, 64), (32, 128), (32, 64), (64, 128), (16, 128), (16, 64),
         (16, 32), (8, 32), (4, 32), (2, 32), (1, 32))
SMS = 132  # streaming multiprocessors of an H100 SXM
THREADS = 256  # threads per CTA
MAX_STREAMS = 64  # streams one launch takes (csrc/fused_segment.cu's kMaxStreams)


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def fused_tile(H: int, W: int) -> tuple:
    """(TH, TW, Hp, Wp): the Pallas kernel's default tile and its padded
    grid over an (H, W) image — a copy of tpuva/ops/pallas/fused_segment.py::
    fused_tile, pinned to it by a CPU test. (Hp, Wp) is padded_occ's output
    shape, and the staged route takes the padded handoff where it aligns to
    64 x 256, as tpuva's does."""
    TH = 96 if H > 128 else _ceil_to(H, 32)
    TW = 1024 if W > 1024 else _ceil_to(W, 128)
    return TH, TW, -(-H // TH) * TH, -(-W // TW) * TW


def _up16(v: int) -> int:
    return (v + 15) & ~15


def bg_regs_kind(tile_h: int, tile_w: int, rm_reach: int) -> int:
    """Where the kernel keeps the background (csrc/fused_segment.cu's
    bg_regs_kind): 1 and 2 in registers, 2 x 8 or 3 x 5 a thread (the M
    region in column groups of 32 and row segments of an eighth), 0 in
    shared memory where the region is larger."""
    cx, seg = -(-(tile_w + 2 * rm_reach) // 32), -(-(tile_h + 2 * rm_reach) // 8)
    return 1 if cx <= 2 and seg <= 8 else 2 if cx <= 3 and seg <= 5 else 0


def smem_bytes(tile_h: int, tile_w: int, ntaps: int, median: bool, rm_reach: int) -> int:
    """Dynamic shared memory of one CTA: csrc/fused_segment.cu's Layout
    (two raw windows, uint16 row sums, blurred region with a median, the
    float32 background unless it lives in registers, two mask buffers, the
    reflect tables)."""
    rm = 1 if median else 0
    P = ntaps // 2 + rm + rm_reach
    WH, WW = tile_h + 2 * P, tile_w + 2 * P
    RP = _up16(WW + 15)
    BH, BW = tile_h + 2 * (rm_reach + rm), tile_w + 2 * (rm_reach + rm)
    HP = (BW + 3) & ~3
    MH, MW = tile_h + 2 * rm_reach, tile_w + 2 * rm_reach
    MP = _up16((16 - rm_reach % 16) % 16 + MW)
    bg = 0 if bg_regs_kind(tile_h, tile_w, rm_reach) else _up16(MH * MW * 4)
    return (2 * _up16(WH * RP) + _up16(WH * HP * 2) + (_up16(BH * BW) if rm else 0)
            + bg + 2 * _up16(MH * MP) + _up16(WH * 4) + _up16(WW * 4))


def variant(ntaps: int) -> int:
    """The kernel instantiation for a tap count (0: the generic one)."""
    return ntaps if ntaps in UNROLLED_TAPS else 0


def modelled_blocks_per_sm(ntaps: int, median: bool, rm_reach: int, tile_h: int,
                           tile_w: int, smem: int) -> int:
    """CTAs per SM from shared memory and threads alone (228 KB an SM, 1 KB
    of it reserved per CTA; 2048 threads): the occupancy the plan assumes
    where it cannot ask a card."""
    return min(2048 // THREADS, (228 * 1024) // (smem + 1024))


class Plan(NamedTuple):
    variant: int  # tap count of the instantiation, 0 = generic
    tile: tuple  # owned (rows, cols) per CTA
    grid: tuple  # CTAs (along x, along y)
    smem: int  # dynamic shared memory per CTA, bytes
    blocks_per_sm: int  # resident CTAs per SM for this instantiation and smem
    waves: int  # ceil(CTAs / (blocks_per_sm * SMs))
    bg_regs: int  # bg_regs_kind: 1, 2 background in registers, 0 in shared memory


def launch_plan(H: int, W: int, ntaps: int, median: bool, rm_reach: int,
                blocks_per_sm: Optional[Callable[..., int]] = None,
                sms: int = SMS, streams: int = 1) -> Plan:
    """The tile for an (H, W) image of `streams` streams in one launch (the
    grid's tiles of every stream share the waves): the least rounds x
    window area, then the fewest CTAs.

    A CTA's frame loop is a chain of dependent steps behind barriers, so a
    wave lasts about as long as one CTA's window takes a frame, times the
    frames; an SM runs `waves` such rounds in turn. With morphology a CTA
    whose tile holds foreground in every frame runs it on top, about twice
    a background CTA's time (PERF.md), so it counts as two rounds at
    least: large tiles in one wave lose to smaller ones in two. blocks_per_sm(ntaps,
    median, rm_reach, tile_h, tile_w, smem) is the card's occupancy (the
    wrapper passes card_blocks_per_sm); without one the plan models it
    from shared memory. Raises ValueError when no tile fits in shared
    memory."""
    v = variant(ntaps)
    occupancy = blocks_per_sm or modelled_blocks_per_sm
    P = ntaps // 2 + (1 if median else 0) + rm_reach
    best = None
    for th, tw in TILES:
        smem = smem_bytes(th, tw, ntaps, median, rm_reach)
        if smem > SMEM_LIMIT:
            continue
        bps = occupancy(ntaps, bool(median), rm_reach, th, tw, smem)
        if bps < 1:
            continue
        grid = (-(-W // tw), -(-H // th))
        ctas = grid[0] * grid[1] * streams
        waves = -(-ctas // (bps * sms))
        rounds = max(waves, 2 if rm_reach else 1)
        key = (rounds * (th + 2 * P) * (tw + 2 * P), ctas)
        if best is None or key < best[0]:
            best = (key, Plan(v, (th, tw), grid, smem, bps, waves,
                              bg_regs_kind(th, tw, rm_reach)))
    if best is None:
        raise ValueError(
            f"fused_segment kernel: blur {ntaps} taps, median {bool(median)} and "
            f"morphology reach {rm_reach} need more shared memory than a CTA has"
        )
    return best[1]


@functools.lru_cache(maxsize=256)
def card_blocks_per_sm(ntaps: int, median: bool, rm_reach: int, tile_h: int, tile_w: int,
                       smem: int) -> int:
    """cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card
    for the instantiation of ntaps at a tile. Raises unless the kernel's
    own shared-memory size is smem_bytes'."""
    lib = _build.load()
    out_smem, out_bps = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.tpuva_fused_segment_occupancy(ntaps, int(median), rm_reach, tile_h, tile_w,
                                            ctypes.addressof(out_smem), ctypes.addressof(out_bps))
    _build.check(lib, err, "fused_segment occupancy")
    if out_smem.value != smem:
        raise RuntimeError(f"fused_segment: the kernel's shared memory ({out_smem.value} B) "
                           f"is not smem_bytes' ({smem} B)")
    return out_bps.value


def fused_segment_plain(
    frames,
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
    emit: str = "mask",
    padded_occ: bool = False,
):
    """Plain PyTorch version of the kernel (same arguments, same results;
    N >= 1): the plain ops only (gaussian_blur_u8, median_u8_plain,
    morph_steps_plain), never a kernel, on either device. With a stream
    axis (frames (S, N, H, W) or a sequence of S batches, bg0 (S, H, W))
    each stream in turn, the results stacked."""
    _check_emit(emit, open_ksize, close_ksize, padded_occ)
    kw = dict(alpha=alpha, threshold=threshold, blur_ksize=blur_ksize, blur_sigma=blur_sigma,
              median_ksize=median_ksize, open_shape=open_shape, open_ksize=open_ksize,
              open_iters=open_iters, close_shape=close_shape, close_ksize=close_ksize,
              close_iters=close_iters, emit=emit, padded_occ=padded_occ)
    if _has_streams(frames):
        seeds = _stream_seeds(seed_bg, len(frames))
        outs = [fused_segment_plain(frames[s], bg0[s], seed_bg=seeds[s], **kw)
                for s in range(len(frames))]
        return tuple(torch.stack(x) for x in zip(*outs))
    f = gaussian_blur_u8(frames, blur_ksize, blur_sigma) if blur_ksize else frames.to(torch.float32)
    if median_ksize:
        f = median_u8_plain(f, median_ksize)
    N, H, W = frames.shape
    if isinstance(seed_bg, torch.Tensor):  # a flag on the frames' device
        bg = torch.where(seed_bg.to(torch.bool), f[0], bg0)
    else:
        bg = f[0] if seed_bg else bg0
    masks = torch.empty((N, H, W), dtype=torch.uint8, device=frames.device)
    for t in range(N):
        bg = background_update(bg, f[t], alpha)
        d = (f[t] - bg).abs()
        if emit == "diff":  # torch.round is rint: half to even
            masks[t] = torch.clamp(torch.round(d), 0, 255).to(torch.uint8)
        else:
            masks[t] = threshold_op(d, threshold)
    masks = morph_steps_plain(masks, open_close_steps(
        ((open_shape, open_ksize, open_iters), (close_shape, close_ksize, close_iters))))
    if padded_occ:
        padded, occ = pad_occ_plain(masks, fused_tile(H, W)[2:])
        return padded, bg, occ
    return masks, bg


def _has_streams(frames) -> bool:
    """Whether fused_segment's frames carry a stream axis: (S, N, H, W), or
    a sequence of S (N, H, W) batches."""
    return isinstance(frames, (list, tuple)) or frames.dim() == 4


def _stream_seeds(seed_bg, S: int) -> list:
    """seed_bg for each of S streams: a bool for all, or an (S,) tensor (its
    elements, on its device)."""
    if isinstance(seed_bg, torch.Tensor):
        if seed_bg.shape != (S,):
            raise ValueError(f"fused_segment: seed_bg must be ({S},), got {tuple(seed_bg.shape)}")
        return list(seed_bg)
    return [bool(seed_bg)] * S


def _check_emit(emit: str, open_ksize: int, close_ksize: int, padded_occ: bool = False) -> None:
    if emit not in ("mask", "diff"):
        raise ValueError(f"fused_segment: emit must be 'mask' or 'diff', got {emit!r}")
    if emit == "diff" and (open_ksize or close_ksize or padded_occ):
        raise ValueError("fused_segment: emit='diff' writes pre-threshold magnitudes, "
                         "so it takes no morphology and no occupancy")


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
    emit: str = "mask",
    padded_occ: bool = False,
):
    """frames (N, H, W) uint8, bg0 (H, W) float32 -> (masks (N, H, W)
    uint8 0/255, final background (H, W) float32); with emit="diff" the
    first output is clip(rint(|F - B|), 0, 255) instead, threshold is
    ignored and open/close must be off. With padded_occ (mask emit only)
    -> (masks (N, Hp, Wp), background, occ128 (N, Hp/2, Wp/128) uint8),
    (Hp, Wp) = fused_tile(H, W)[2:]: the masks zero outside the image,
    occ128 1 where a 2-row x 128-column block holds foreground.

    blur_ksize 0 = no blur; median_ksize 0 or 3; open/close ksize 0 = off.
    CPU tensors run fused_segment_plain; CUDA tensors launch the kernel,
    with the blur or the morphology in kernels of their own where one
    launch does not take them (k1_split).

    frames (S, N, H, W) or a sequence of S (N, H, W) batches, with bg0
    (S, H, W), are S streams (the module's docstring): every output leads
    with (S,), and seed_bg may be one flag a stream."""
    _check_emit(emit, open_ksize, close_ksize, padded_occ)
    kw = dict(
        alpha=alpha, threshold=threshold, blur_ksize=blur_ksize,
        blur_sigma=blur_sigma, median_ksize=median_ksize,
        open_shape=open_shape, open_ksize=open_ksize, open_iters=open_iters,
        close_shape=close_shape, close_ksize=close_ksize,
        close_iters=close_iters, seed_bg=seed_bg, emit=emit,
    )
    if _has_streams(frames):
        return _fused_segment_streams(frames, bg0, padded_occ, kw)
    if frames.dim() != 3 or frames.dtype != torch.uint8:
        raise ValueError("fused_segment: frames must be (N, H, W) uint8")
    N, H, W = frames.shape
    if bg0.shape != (H, W) or bg0.dtype != torch.float32 or bg0.device != frames.device:
        raise ValueError("fused_segment: bg0 must be (H, W) float32 on the frames' device")
    if median_ksize not in (0, 3):
        raise NotImplementedError("fused_segment: median_ksize must be 0 or 3")
    if N == 0:
        if padded_occ:
            Hp, Wp = fused_tile(H, W)[2:]
            return (torch.zeros((0, Hp, Wp), dtype=torch.uint8, device=frames.device),
                    bg0.clone(),
                    torch.zeros((0, Hp // 2, Wp // 128), dtype=torch.uint8, device=frames.device))
        return torch.empty_like(frames), bg0.clone()
    if frames.device.type == "cpu":
        return fused_segment_plain(frames, bg0, padded_occ=padded_occ, **kw)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_segment: unsupported device {frames.device}")
    return run_split(frames.contiguous(), bg0.contiguous(), k1_split(H, W, **kw),
                     _k1_launch, padded_occ=padded_occ, **kw)


def _fused_segment_streams(frames, bg0, padded_occ: bool, kw: dict):
    """fused_segment over S streams: the checks, then the plain version on
    the CPU; on the card one launch for all streams, or, where k1_split
    takes a stage out of K1, run_split a stream at a time."""
    fr = list(frames)
    S = len(fr)
    if not 1 <= S <= MAX_STREAMS:
        raise ValueError(f"fused_segment: a stream axis takes 1 to {MAX_STREAMS} streams, got {S}")
    N, H, W = fr[0].shape if fr[0].dim() == 3 else (-1, -1, -1)
    dev = fr[0].device
    if any(f.dim() != 3 or f.shape != (N, H, W) or f.dtype != torch.uint8 or f.device != dev
           for f in fr):
        raise ValueError("fused_segment: every stream's frames must be (N, H, W) uint8, the "
                         "same shape on one device")
    if bg0.shape != (S, H, W) or bg0.dtype != torch.float32 or bg0.device != dev:
        raise ValueError("fused_segment: bg0 must be (S, H, W) float32 on the frames' device")
    if kw["median_ksize"] not in (0, 3):
        raise NotImplementedError("fused_segment: median_ksize must be 0 or 3")
    seed = kw["seed_bg"]
    _stream_seeds(seed, S)  # checks a tensor's shape
    if isinstance(seed, torch.Tensor) and seed.device != dev:
        raise ValueError("fused_segment: seed_bg flags must lie on the frames' device")
    if N == 0:
        empty = [fused_segment(f, b, padded_occ=padded_occ, **dict(kw, seed_bg=False))
                 for f, b in zip(fr, bg0)]
        return tuple(torch.stack(x) for x in zip(*empty))
    if dev.type == "cpu":
        return fused_segment_plain(fr, bg0, padded_occ=padded_occ, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_segment: unsupported device {dev}")
    return run_streams([f.contiguous() for f in fr], bg0.contiguous(), k1_split(H, W, **kw),
                       _k1_launch, padded_occ=padded_occ, **kw)


def run_streams(frames: list, bg0, parts, k1, padded_occ=False, **kw):
    """fused_segment's stream axis as the card runs it: frames a list of S
    (N, H, W) batches, bg0 (S, H, W), S <= MAX_STREAMS. Where parts
    (k1_split's) keeps every stage in K1, k1(frames, bg0, **options) once
    (one launch on the card; the CPU tests pass fused_segment_plain);
    otherwise run_split a stream at a time, each with its own seed flag.
    Returns the outputs stacked along (S,)."""
    if parts == (False, False):
        return k1(frames, bg0, padded_occ=padded_occ, **kw)
    S = len(frames)
    seeds = _stream_seeds(kw["seed_bg"], S)
    outs = [run_split(frames[s], bg0[s], parts, k1, padded_occ=padded_occ,
                      **dict(kw, seed_bg=seeds[s])) for s in range(S)]
    return tuple(torch.stack(x) for x in zip(*outs))


def _k1_launch(frames, bg0, padded_occ=False, **kw):
    out = _fused_segment_cuda(frames, bg0, padded_occ=padded_occ, **kw)
    fused_segment.launches += 1
    fused_segment.padded_launches += bool(padded_occ)
    fused_segment.stream_launches += _has_streams(frames)
    return out


def _k1_options(kw: dict, blur_apart: bool, morph_apart: bool) -> dict:
    """fused_segment's options less the stages taken out of K1."""
    kw = dict(kw)
    if blur_apart:
        kw.update(blur_ksize=0, blur_sigma=0.0)
    if morph_apart:
        kw.update(open_ksize=0, close_ksize=0)
    return kw


def k1_split(H: int, W: int, **kw) -> tuple[bool, bool]:
    """(blur apart, morphology apart): the stages fused_segment takes out of
    K1's launch on an (H, W) image so that k1_takes takes the rest — none,
    then the blur, then the open and close, then both; a stage is only
    taken out where the options have it. With both out, one launch holds a
    median 3 and no morphology, which every candidate tile fits. A pure
    function of the shapes and options, as k1_takes."""
    if kw.get("median_ksize", 0) not in (0, 3):
        raise NotImplementedError("fused_segment: median_ksize must be 0 or 3")
    has_blur = kw.get("blur_ksize", 0) > 1
    has_morph = bool(kw.get("open_ksize", 0) or kw.get("close_ksize", 0))
    for parts in ((False, False), (True, False), (False, True), (True, True)):
        if (parts[0] and not has_blur) or (parts[1] and not has_morph):
            continue
        if k1_takes(H, W, **_k1_options(kw, *parts)):
            return parts
    raise ValueError("fused_segment: no split of these options fits the kernel")


def run_split(frames, bg0, parts, k1, padded_occ=False, **kw):
    """fused_segment's options as parts = (blur apart, morphology apart)
    say: blur_u8 on the frames, k1(frames, bg0, **options) with the stages
    that stay (the kernel's launch on the card; the CPU tests pass
    fused_segment_plain), then open_close_u8 on its masks. Bit-equal to one
    pass over all the options: the blur's output is u8, as the median and
    the background see it inside K1, and the morphology follows the
    threshold. With padded_occ, k1 writes the padded mask and occ128 where
    the morphology stays in it, and the last open_close_u8 step where it
    does not, so that the occupancy is the final mask's."""
    blur_apart, morph_apart = parts
    if blur_apart:
        frames = blur_u8(frames, kw["blur_ksize"], kw["blur_sigma"])
    options = _k1_options(kw, blur_apart, morph_apart)
    if not morph_apart:
        return k1(frames, bg0, padded_occ=padded_occ, **options)
    masks, bg = k1(frames, bg0, **options)
    stages = ((kw["open_shape"], kw["open_ksize"], kw["open_iters"]),
              (kw["close_shape"], kw["close_ksize"], kw["close_iters"]))
    if padded_occ:
        padded, occ = open_close_u8(masks, stages, pad_to=fused_tile(*masks.shape[1:])[2:])
        return padded, bg, occ
    return open_close_u8(masks, stages), bg


def _stages(open_shape, open_ksize, open_iters, close_shape, close_ksize, close_iters):
    """The kernel's four morphology stages, (shape, ksize, iterations):
    erode+dilate (open), then dilate+erode (close)."""
    return [(open_shape, open_ksize, open_iters), (open_shape, open_ksize, open_iters),
            (close_shape, close_ksize, close_iters), (close_shape, close_ksize, close_iters)]


def _ntaps(blur_ksize: int, blur_sigma: float) -> int:
    return len(blur_taps(blur_ksize, blur_sigma)[0]) if blur_ksize else 1


def _reach(open_ksize: int, open_iters: int, close_ksize: int, close_iters: int) -> int:
    """The morphology's reach: erode + dilate of the open, then of the close."""
    return sum((k // 2) * it for k, it in ((open_ksize, open_iters), (close_ksize, close_iters))
               if k) * 2


def k1_takes(H: int, W: int, *, blur_ksize: int = 0, blur_sigma: float = 0.0,
             median_ksize: int = 0, open_ksize: int = 0, open_iters: int = 1,
             close_ksize: int = 0, close_iters: int = 1, **_unused) -> bool:
    """True exactly when one launch of the kernel takes fused_segment's
    options on an (H, W) image: median 0 or 3, at most MAX_TAPS blur taps,
    structuring elements at most MAX_SE wide, and a candidate tile whose
    shared memory fits a CTA (launch_plan's fit test; no tile's size
    depends on H and W today). The launch refuses through it and k1_split
    splits on it. A pure function of the shapes and options that queries
    no card. Options that do not shape the launch are ignored."""
    if median_ksize not in (0, 3):
        return False
    ntaps = _ntaps(blur_ksize, blur_sigma)
    if ntaps > MAX_TAPS or max(open_ksize, close_ksize) > MAX_SE:
        return False
    reach = _reach(open_ksize, open_iters, close_ksize, close_iters)
    return any(smem_bytes(th, tw, ntaps, bool(median_ksize), reach) <= SMEM_LIMIT
               for th, tw in TILES)


def fused_segment_plan(H: int, W: int, *, blur_ksize: int = 0, blur_sigma: float = 0.0,
                       median_ksize: int = 0, open_ksize: int = 0, open_iters: int = 1,
                       close_ksize: int = 0, close_iters: int = 1,
                       blocks_per_sm: Optional[Callable[..., int]] = None, sms: int = SMS,
                       streams: int = 1, **_unused) -> Plan:
    """launch_plan for fused_segment's options on an (H, W) image of
    `streams` streams; pass blocks_per_sm=card_blocks_per_sm and the card's
    SM count for the card (the wrapper does), or nothing for the
    shared-memory model of an H100 SXM. Options that do not shape the
    launch are ignored."""
    return launch_plan(H, W, _ntaps(blur_ksize, blur_sigma), bool(median_ksize),
                       _reach(open_ksize, open_iters, close_ksize, close_iters),
                       blocks_per_sm, sms, streams)


def _fused_segment_cuda(frames, bg0, *, alpha, threshold, blur_ksize=0, blur_sigma=0.0,
                        median_ksize=0, open_shape="rect", open_ksize=0, open_iters=1,
                        close_shape="rect", close_ksize=0, close_iters=1, seed_bg=False,
                        emit="mask", tile=None, padded_occ=False):
    """The launch, on contiguous CUDA tensors that fused_segment checked:
    frames (N, H, W) and bg0 (H, W), or S <= MAX_STREAMS streams, frames a
    sequence of S (N, H, W) batches (or (S, N, H, W)) and bg0 (S, H, W),
    every output then leading with (S,); seed_bg a bool, or a tensor of
    one flag a stream on the card. tile (rows, cols) overrides
    launch_plan's (the tests and the smoke's timing force each candidate).
    Does not count a launch of the main path: fused_segment does, around
    it."""
    _check_emit(emit, open_ksize, close_ksize, padded_occ)
    streams = _has_streams(frames)
    fr = list(frames) if streams else [frames]
    S = len(fr)
    if not 1 <= S <= MAX_STREAMS:
        raise ValueError(f"fused_segment kernel: 1 to {MAX_STREAMS} streams a launch, got {S}")
    bgs = bg0 if streams else bg0[None]
    N, H, W = fr[0].shape
    if not k1_takes(H, W, blur_ksize=blur_ksize, blur_sigma=blur_sigma,
                    median_ksize=median_ksize, open_ksize=open_ksize, open_iters=open_iters,
                    close_ksize=close_ksize, close_iters=close_iters):
        raise ValueError("fused_segment kernel: one launch does not take these options "
                         "(k1_takes; fused_segment splits them with k1_split)")
    taps, shift = blur_taps(blur_ksize, blur_sigma) if blur_ksize else ((1,), 0)
    stages = _stages(open_shape, open_ksize, open_iters, close_shape, close_ksize, close_iters)
    if tile is None:
        with torch.cuda.device(fr[0].device):  # the occupancy of this card
            tile = fused_segment_plan(
                H, W, blur_ksize=blur_ksize, blur_sigma=blur_sigma, median_ksize=median_ksize,
                open_ksize=open_ksize, open_iters=open_iters, close_ksize=close_ksize,
                close_iters=close_iters, blocks_per_sm=card_blocks_per_sm,
                sms=torch.cuda.get_device_properties(fr[0].device).multi_processor_count,
                streams=S).tile
    stage_k = np.array([k for _, k, _ in stages], np.int32)
    stage_iters = np.array([it if k else 0 for _, k, it in stages], np.int32)
    stage_se = np.zeros((4, MAX_SE), np.uint32)
    for s, (shape, k, _) in enumerate(stages):
        if k:
            stage_se[s, :k] = _se_rows(shape, k)
    taps_np = np.array(taps, np.int32)
    c1, a = background_coeffs(alpha)
    dev = fr[0].device
    Hp, Wp = fused_tile(H, W)[2:] if padded_occ else (H, W)
    masks = torch.empty((S, N, Hp, Wp), dtype=torch.uint8, device=dev)
    occ = (torch.empty((S, N, Hp // 2, Wp // 128), dtype=torch.uint8, device=dev)
           if padded_occ else None)
    bg_out = torch.empty((S, H, W), dtype=torch.float32, device=dev)
    seed = None  # one flag a stream on the card, else seed_bg for all
    if isinstance(seed_bg, torch.Tensor):
        seed = seed_bg.reshape(-1).to(torch.uint8).contiguous()
        if seed.numel() != S or seed.device != dev:
            raise ValueError(f"fused_segment kernel: seed_bg must be {S} flags on {dev}")
    ptrs = (ctypes.c_void_p * S)(*(f.data_ptr() for f in fr))
    _build.launch(
        dev, "tpuva_fused_segment", "fused_segment kernel",
        ptrs, S, bgs.data_ptr(), masks.data_ptr(), bg_out.data_ptr(),
        N, H, W, c1, a, float(np.float32(threshold)),
        taps_np.ctypes.data, len(taps), shift, 1 if median_ksize else 0,
        stage_k.ctypes.data, stage_iters.ctypes.data, stage_se.ctypes.data,
        0 if seed is not None or not seed_bg else 1,
        None if seed is None else seed.data_ptr(),
        1 if emit == "diff" else 0, tile[0], tile[1],
        Hp, Wp, None if occ is None else occ.data_ptr(),
    )
    out = (masks, bg_out, occ) if padded_occ else (masks, bg_out)
    return out if streams else tuple(x[0] for x in out)


fused_segment.launches = 0  # every K1 launch
fused_segment.padded_launches = 0  # those with padded_occ
fused_segment.stream_launches = 0  # those with a stream axis
