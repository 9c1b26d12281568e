"""Running-average background model — port of ``tpuva/ops/background.py``.

cv2.accumulateWeighted semantics: ``B <- (1-alpha)*B + alpha*F`` in
float32, rounded exactly as the reference rounds it: ``c1 = 1 - alpha``
in float32 on the host, then two products and one add, each its own
rounding. ``torch.lerp``, ``addcmul`` and ``add(..., alpha=)`` are avoided
on purpose: they may fuse into a single rounding and move the threshold
edge. The fused front-end kernel does the same with ``__fmul_rn`` /
``__fadd_rn``.

``background_scan`` runs that model over a batch and emits |F - B| as a
mask or as rounded magnitudes, in either of tpuva's orders: ``"scan"``,
``background_trajectory(parallel=True)``'s associative scan of the affine
maps B -> s B + o (``tpuva/graph/pipeline.py:85``, every ``parallel_bg``
route), or ``"sequential"``, one update a frame (``FilterBackground`` on
float frames, ``tpuva/filters.py:403``). A CUDA tensor launches kernel KS
(``csrc/background.cu``, ``tpuva_background_scan``) once; a CPU tensor
takes ``background_scan_plain``, the torch ops KS is held to. The scan's
s values are scalars shared by every pixel: ``scan_tables`` replays the
kernel's in-place loops on them on the host in float32, once a (N,
alpha), and KS reads the table; ``scan_model`` is a numpy copy of the
kernel's loops over the o values, which the CPU tests hold to the
recursion. ``scan_plan`` sizes KS's launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpuva_torch import _build
from tpuva_torch.ops.filters import threshold as _threshold


def background_coeffs(alpha) -> tuple[float, float]:
    """(c1, a) = (float32(1) - float32(alpha), float32(alpha)) as Python
    floats holding exact float32 values."""
    a = np.float32(alpha)
    return float(np.float32(1) - a), float(a)


def background_update(bg: torch.Tensor, frame: torch.Tensor, alpha) -> torch.Tensor:
    """One update step. bg, frame: (..., H, W) float32."""
    c1, a = background_coeffs(alpha)
    return c1 * bg + a * frame


def background_update_masked(bg: torch.Tensor, frame: torch.Tensor, alpha,
                             mask: torch.Tensor) -> torch.Tensor:
    """cv2.accumulateWeighted's optional update mask: pixels where mask is
    False keep the old background."""
    return torch.where(mask, background_update(bg, frame, alpha), bg)


def _affine_scan(s: torch.Tensor, o: torch.Tensor):
    """Inclusive scan of the affine maps x -> s_t x + o_t along axis 0, in
    the combination tree of jax.lax.associative_scan (pairs, recursion on
    the odd elements, then the even ones), so that the float32 products
    and sums are taken in the reference's order."""
    n = s.shape[0]
    if n < 2:
        return s, o

    def combine(s1, o1, s2, o2):  # apply (s1, o1) first, then (s2, o2)
        return s1 * s2, s2 * o1 + o2

    odd_s, odd_o = _affine_scan(*combine(s[0:-1:2], o[0:-1:2], s[1::2], o[1::2]))
    if n % 2 == 0:
        ev_s, ev_o = combine(odd_s[:-1], odd_o[:-1], s[2::2], o[2::2])
    else:
        ev_s, ev_o = combine(odd_s, odd_o, s[2::2], o[2::2])
    out = []
    for first, ev, od in ((s, ev_s, odd_s), (o, ev_o, odd_o)):
        x = torch.empty_like(first)
        x[0::2] = torch.cat([first[:1], ev])
        x[1::2] = od
        out.append(x)
    return out[0], out[1]


def scan_trajectory(bg0: torch.Tensor, frames: torch.Tensor, alpha) -> torch.Tensor:
    """All post-update backgrounds B_1..B_N of float32 frames (N, ...) as
    tpuva's associative scan: B_t = S_t * B_0 + O_t, two roundings."""
    c1, a = background_coeffs(alpha)
    shape = (frames.shape[0],) + (1,) * (frames.dim() - 1)
    s = torch.full(shape, c1, dtype=torch.float32, device=frames.device)
    S, O = _affine_scan(s, a * frames)
    return S * bg0[None] + O


def _seeded(seed_bg, first: torch.Tensor, bg0: torch.Tensor) -> torch.Tensor:
    """The starting background: the first frame where seed_bg (a bool, or
    a flag on the frames' device) is set, else bg0."""
    if isinstance(seed_bg, torch.Tensor):
        return torch.where(seed_bg.to(torch.bool), first, bg0)
    return first if seed_bg else bg0


def _emit(diff: torch.Tensor, emit: str, thr) -> torch.Tensor:
    if emit == "mask":
        return _threshold(diff, thr)
    return torch.clamp(torch.round(diff), 0, 255).to(torch.uint8)  # round: half to even


def background_scan_plain(frames: torch.Tensor, bg0: torch.Tensor, alpha, seed_bg=False,
                          order: str = "scan", emit: str = "mask", threshold=None):
    """KS's plain version, torch ops: frames (N, ...) uint8 or float32,
    bg0 (...) float32 -> (out (N, ...) uint8, B_{N-1} float32).

    order "scan": the associative scan (scan_trajectory), then |F - B|;
    "sequential": one background_update a frame, |F_t - B_t| after each.
    emit "mask": |F - B| > float32(threshold) -> 255, else 0; "diff":
    clip(rint(|F - B|), 0, 255). Every float32 op is rounded on its own."""
    f = frames.to(torch.float32)
    b = _seeded(seed_bg, f[0], bg0)
    if order == "scan":
        bgs = scan_trajectory(b, f, alpha)
        bg_last = bgs[-1].clone()  # not a view that keeps the batch alive
        diff = (f - bgs).abs()
        del f, bgs
        return _emit(diff, emit, threshold), bg_last
    diff = torch.empty_like(f)
    for t in range(f.shape[0]):
        b = background_update(b, f[t], alpha)
        diff[t] = (f[t] - b).abs()
    return _emit(diff, emit, threshold), b


@functools.lru_cache(maxsize=64)
def scan_tables(N: int, alpha) -> np.ndarray:
    """The scan's per-node scalars for N frames, float32: the s2 of every
    combine of KS's in-place loops, in the order the loops visit them,
    then the final S_t (N). The up-sweep pairs (x[q - d], x[q]) at q = (2k
    + 2)d - 1 for the (N >> l) // 2 pairs of level l (d = 2^l), while
    N >> l >= 2; the down-sweep, from the deepest level back, q = (2k +
    1)d - 1 for k = 1 .. ((N >> l) - 1) // 2. Each combine records s[q]
    and sets s[q] = s[q - d] * s[q]: the s half of
    jax.lax.associative_scan's combination tree, node by node. Kept once a
    (N, alpha): read only."""
    c1 = np.float32(background_coeffs(alpha)[0])
    s = np.full(N, c1, np.float32)
    s2 = []
    for q, d in _scan_ops(N):
        s2.append(s[q])
        s[q] = np.float32(s[q - d] * s[q])
    return np.concatenate([np.asarray(s2, np.float32), s]).astype(np.float32)


def _scan_ops(N: int):
    """(q, d) of every combine of KS's loops over N elements, in order."""
    levels = 0
    while (N >> levels) >= 2:
        levels += 1
    for lvl in range(levels):  # up-sweep
        d = 1 << lvl
        for k in range((N >> lvl) >> 1):
            yield (2 * k + 2) * d - 1, d
    for lvl in range(levels, 0, -1):  # down-sweep
        d = 1 << (lvl - 1)
        for k in range(1, (((N >> (lvl - 1)) - 1) >> 1) + 1):
            yield (2 * k + 1) * d - 1, d


def scan_model(o: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """A numpy copy of KS's scan loops over the o values (N, ...) float32
    with scan_tables' s2: x[q] = s2 * x[q - d] + x[q], each op rounded on
    its own. Returns the O_t of every t; nothing on the main path calls
    it."""
    x = np.array(o, np.float32)
    for i, (q, d) in enumerate(_scan_ops(x.shape[0])):
        x[q] = (tables[i] * x[q - d]).astype(np.float32) + x[q]
    return x


@functools.lru_cache(maxsize=64)
def device_scan_tables(N: int, alpha, device: torch.device) -> torch.Tensor:
    """scan_tables(N, alpha) on device, uploaded once and kept."""
    return torch.from_numpy(scan_tables(N, alpha)).to(device)


# bytes of shared memory a CTA can have on an H100 (227 KB)
KS_SMEM_MAX = 232448
KS_THREADS = 256  # the most pixels a CTA of KS's scan
KS_GLOBAL_CTAS = 264  # CTAs of the global-scratch route: 2 an SM of an H100


class ScanPlan(NamedTuple):
    px: int  # pixels (threads) a CTA
    shared: bool  # each pixel's N values in shared memory, else global scratch
    smem: int  # dynamic shared memory bytes a CTA
    grid: int  # CTAs
    scratch: int  # floats of global scratch (0 on the shared route)


def scan_plan(N: int, P: int) -> ScanPlan:
    """KS's scan launch for N frames of P pixels: the most pixels a CTA, a
    multiple of 32 up to KS_THREADS, whose N float32 values fit
    KS_SMEM_MAX (224 at N = 256, 32 at N = 1024); past N = 1816 not even
    32 fit, and each thread's column lies in a global scratch, KS_THREADS
    pixels a CTA over a grid-stride loop of KS_GLOBAL_CTAS CTAs."""
    px = min(KS_THREADS, KS_SMEM_MAX // (4 * N) // 32 * 32)
    if px >= 32:
        return ScanPlan(px, True, 4 * N * px, -(-P // px), 0)
    grid = min(-(-P // KS_THREADS), KS_GLOBAL_CTAS)
    return ScanPlan(KS_THREADS, False, 0, grid, N * grid * KS_THREADS)


ORDERS = {"scan": 0, "sequential": 1}
EMITS = ("mask", "diff")
KS_SEQ_THREADS = 256  # csrc/background.cu kSeqThreads


def _background_scan_cuda(frames, bg0, alpha, seed_bg, order, emit, thr):
    f = frames if frames.dtype in (torch.uint8, torch.float32) else frames.to(torch.float32)
    f = f.contiguous()
    dev = f.device
    N = f.shape[0]
    P = f[0].numel()
    if tuple(bg0.shape) != tuple(f.shape[1:]) or bg0.device != dev:
        raise ValueError(f"background_scan: bg0 must be {tuple(f.shape[1:])} on {dev}")
    b0 = bg0.to(torch.float32).contiguous()
    out = torch.empty(f.shape, dtype=torch.uint8, device=dev)
    bg_last = torch.empty(f.shape[1:], dtype=torch.float32, device=dev)
    seed = None
    if isinstance(seed_bg, torch.Tensor):
        seed = seed_bg.reshape(-1).to(torch.uint8).contiguous()
        if seed.numel() != 1 or seed.device != dev:
            raise ValueError(f"background_scan: seed_bg must be one flag on {dev}")
    c1, a = background_coeffs(alpha)
    tables, ops, scratch, px, shared = None, 0, None, 0, 0
    if order == "scan":
        plan = scan_plan(N, P)
        tables = device_scan_tables(N, float(np.float32(alpha)), dev)
        ops = tables.numel() - N
        px, shared, grid = plan.px, int(plan.shared), plan.grid
        if not plan.shared:
            scratch = torch.empty(plan.scratch, dtype=torch.float32, device=dev)
    else:
        grid = min(-(-P // KS_SEQ_THREADS), 65535)
    _build.launch(dev, "tpuva_background_scan", "background_scan kernel", f.data_ptr(),
                  int(f.dtype == torch.float32), b0.data_ptr(), out.data_ptr(),
                  bg_last.data_ptr(), P, N, ORDERS[order],
                  None if tables is None else tables.data_ptr(), ops, c1, a,
                  float(np.float32(0.0 if thr is None else thr)), int(emit == "diff"),
                  0 if seed is not None or not seed_bg else 1,
                  None if seed is None else seed.data_ptr(), px, shared, grid,
                  None if scratch is None else scratch.data_ptr())
    background_scan.launches += 1
    if order == "sequential":
        background_scan.sequential_launches += 1
    return out, bg_last


def background_scan(frames: torch.Tensor, bg0: torch.Tensor, alpha, seed_bg=False,
                    order: str = "scan", emit: str = "mask", threshold=None):
    """The running-average background over a batch and its emit: frames
    (N, ...) uint8 or float32, bg0 (...) float32; seed_bg (a bool, or one
    flag on the frames' device) starts B from the first frame. Returns
    (out (N, ...) uint8, the post-batch background (...) float32).

    order "scan" (tpuva's associative scan, parallel_bg) or "sequential"
    (one update a frame); emit "mask" (|F - B| > float32(threshold) ->
    255, else 0) or "diff" (clip(rint(|F - B|), 0, 255)). CUDA tensors
    launch kernel KS once (background_scan.launches counts them,
    .sequential_launches those of the sequential order; another dtype than
    uint8 and float32 is cast to float32 first); CPU tensors take
    background_scan_plain."""
    if order not in ORDERS or emit not in EMITS:
        raise ValueError(f"background_scan: order {order!r} or emit {emit!r} unknown")
    if emit == "mask" and threshold is None:
        raise ValueError("background_scan: the mask emit needs a threshold")
    if frames.dim() < 1 or frames.shape[0] == 0:
        raise ValueError("background_scan: frames must be (N, ...) with N >= 1")
    if frames.device.type == "cpu":
        return background_scan_plain(frames, bg0, alpha, seed_bg, order, emit, threshold)
    if frames.device.type != "cuda":
        raise ValueError(f"background_scan: unsupported device {frames.device}")
    if frames[0].numel() == 0:
        return (torch.empty(frames.shape, dtype=torch.uint8, device=frames.device),
                bg0.to(torch.float32).clone())
    return _background_scan_cuda(frames, bg0, alpha, seed_bg, order, emit, threshold)


background_scan.launches = 0
background_scan.sequential_launches = 0
