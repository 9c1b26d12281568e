"""The exact k x k median of uint8 frames — kernel K7 (``median_u8``), its
plain version, and the selection networks its register tier runs.

Replaces tpuva's ``median_blur`` (``tpuva/ops/filters.py``) for uint8
frames on the card: cv2.medianBlur's exact median with BORDER_REPLICATE,
for every odd k. tpuva runs it as jnp (a sort of the k*k window stack) on
the TPU; no Pallas kernel carries it.

- CUDA tensors launch ``csrc/median.cu`` once. For k = 3, 5, 7 and 9 a
  thread computes a block of BX x BY outputs in each of two row bands at
  once (two pixels a 32-bit word, one in each 16-bit lane) by the min/max
  network ``median_network(k)`` below: Adams's separable sorting network
  (ACM TOG 40(4), 2021), pruned to the median. From k = HIST_MIN_K on a
  thread slides a column's 256-bin histogram down a strip of rows
  (Huang's 2k updates a pixel), with a 16-bin coarse level that bounds
  the median's walk; ``hist_plan`` is its launch. A failed build or
  launch raises.
- CPU tensors take the plain version, ``median_u8_plain`` (the torch ops
  of ``ops/filters.py``: the 19-op network for k = 3, the chunked sort of
  the window stack for a larger k), which the kernel is bit-equal to;
  ``median_u8_counts_plain`` gives the same medians in memory that does
  not grow with k (the yardstick at large k and 1080p).

The networks live here and only here: ``_build`` writes
``network_header()`` (each network as straight-line CUDA) into the build
directory before nvcc runs, and the CPU tests evaluate the same op lists
(``tests/test_torch_median_network.py``).

``ops.filters.median_blur`` (and through it ``filters.FilterMedian``)
routes a uint8 tensor on the card here; every other dtype keeps the torch
sort. The median route of ``graph.pipeline`` (a median k > 3) runs K1b,
then K7, then K1 without its blur and median.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpuva_torch import _build
from tpuva_torch.ops.filters import median_u8_counts_plain, median_u8_plain

__all__ = ["median_u8", "median_hist_u8", "median_u8_plain", "median_u8_counts_plain",
           "median_network", "net_tile", "network_header", "network_ops_per_px", "hist_plan",
           "hist_ops_per_px", "NET_BLOCKS", "NET_LAUNCH", "HIST_MIN_K"]

# The output block (BX columns, BY rows) one thread computes in each lane,
# for each k the network tier takes: the block shares its column sorts
# (vertically) and its column merges (horizontally).
NET_BLOCKS = {3: (8, 2), 5: (8, 2), 7: (8, 2), 9: (4, 2)}
# The network kernel's CTA for each k: threads, and the CTAs an SM its
# launch bounds ask for; NET_TILE_W columns of each of two row bands.
# Written into the generated header with the networks; csrc/median.cu
# sizes its tile from them.
NET_LAUNCH = {3: (128, 10), 5: (128, 5), 7: (128, 2), 9: (128, 3)}
NET_TILE_W = 128
LANES = 2  # pixels a 32-bit word (16-bit lanes)
# the least k of the histogram tier (csrc/median.cu's kHistMinK): the
# networks take the odd k below it
HIST_MIN_K = 11
H100_SMS = 132


class MedianNetwork(NamedTuple):
    """A min/max network over a block's (rows x cols) input window, row
    major: input wire i * cols + j is the window's row i, column j; op n
    makes wire rows * cols + n. ops: (kind, a, b, c) with kind "min",
    "max" (c is -1) or "min3", "max3"; outputs[t * bx + x] is the median of
    output (row t, column x), whose window is rows t..t+k-1, columns
    x..x+k-1."""

    k: int
    bx: int
    by: int
    rows: int
    cols: int
    ops: tuple
    outputs: tuple

    @property
    def comparisons(self) -> int:
        """Two-input min/max operations (a min3 or max3 counts two)."""
        return sum(2 if kind.endswith("3") else 1 for kind, *_ in self.ops)


class _Builder:
    """The min/max ops of a network, in the order they are made (every
    sharing comes from the sorted lists being built once)."""

    def __init__(self, n_in):
        self.n_in = n_in
        self.ops = []

    def op(self, kind, a, b):
        self.ops.append((kind, a, b))
        return self.n_in + len(self.ops) - 1

    def merge(self, A, B):
        """Batcher's odd-even merge of sorted wire lists of any lengths."""
        if not A or not B:
            return list(A or B)
        if len(A) == 1 and len(B) == 1:
            return [self.op("min", A[0], B[0]), self.op("max", A[0], B[0])]
        v = self.merge(A[0::2], B[0::2])
        w = self.merge(A[1::2], B[1::2])
        out = [v[0]]
        n = min(len(w), len(v) - 1)
        for j in range(n):
            out += [self.op("min", w[j], v[j + 1]), self.op("max", w[j], v[j + 1])]
        return out + w[n:] + v[n + 1:]


class _Sorted:
    """A sorted list of wires: one input wire, or the merge of two lists
    (kids). Only a window of its positions, what its consumers demand, is
    built."""

    def __init__(self, wire=None, kids=()):
        self.wire, self.kids = wire, kids
        self.n = kids[0].n + kids[1].n if kids else 1
        self.lo = self.hi = None
        self.built = None

    def demand(self, lo, hi):
        lo, hi = max(lo, 0), min(hi, self.n - 1)
        if lo <= hi:
            self.lo = lo if self.lo is None else min(self.lo, lo)
            self.hi = hi if self.hi is None else max(self.hi, hi)

    def push_demand(self):
        """A merged list's positions lo..hi need positions lo - |B|..hi of A
        (the lower ones lie below position lo whatever B holds)."""
        if self.lo is not None and self.kids:
            a, b = self.kids
            a.demand(self.lo - b.n, self.hi)
            b.demand(self.lo - a.n, self.hi)

    def build(self, net):
        """{position: wire} over the demanded window."""
        if self.built is None:
            if self.lo is None:
                self.built = {}
            elif not self.kids:
                self.built = {0: self.wire}
            else:
                A, B = (c.build(net) for c in self.kids)
                a0 = min(A, default=self.kids[0].n)
                b0 = min(B, default=self.kids[1].n)
                M = net.merge([A[i] for i in sorted(A)], [B[i] for i in sorted(B)])
                self.built = {t: M[t - a0 - b0] for t in range(self.lo, self.hi + 1)}
        return self.built


def _shared(items, n_out, k, cache):
    """The sorted union of items[t..t+k-1] for each output t < n_out, the
    units each set of outputs has in common merged once (Adams): a set's
    list is its parent set's list merged with the units the parent lacks,
    down to single outputs."""
    def tree(units):
        key = tuple(map(id, units))
        if key not in cache:
            h = len(units) // 2
            cache[key] = units[0] if len(units) == 1 else _Sorted(
                kids=(tree(units[:h]), tree(units[h:])))
        return cache[key]

    res = [None] * n_out

    def rec(lo, hi, parent, have):
        common = set(range(hi - 1, lo + k))
        extra = sorted(common - have)
        ext = tree([items[i] for i in extra]) if extra else None
        s = ext if parent is None else parent if ext is None else _Sorted(kids=(parent, ext))
        if hi - lo == 1:
            res[lo] = s
            return
        mid = (lo + hi) // 2
        rec(lo, mid, s, common)
        rec(mid, hi, s, common)

    rec(0, n_out, None, set())
    return res


def _fuse3(n_in, ops, outputs):
    """Fold a min (max) whose one operand is a min (max) used only there
    into a three-input min3 (max3)."""
    uses = {}
    for _kind, a, b in ops:
        uses[a] = uses.get(a, 0) + 1
        uses[b] = uses.get(b, 0) + 1
    for w in outputs:
        uses[w] = uses.get(w, 0) + 1
    out, folded = [], set()
    for n, (kind, a, b) in enumerate(ops):
        for x, y in ((a, b), (b, a)):
            src = x - n_in
            if src >= 0 and x not in folded and uses[x] == 1 and out[src][0] == kind:
                folded.add(x)
                out.append((kind + "3", out[src][1], out[src][2], y))
                break
        else:
            out.append((kind, a, b, -1))
    return out, folded


@functools.lru_cache(maxsize=None)
def median_network(k: int) -> MedianNetwork:
    """K7's network for window k (3, 5, 7 or 9): each input column of the
    block sorted for each output row, the sorts shared between output rows;
    then for each output the median (rank k*k // 2) of the union of its k
    sorted columns, the merges shared between output columns; every merge
    built only over the positions that can reach a median. Dead ops are
    dropped and single-use chains folded into min3/max3. Ops are in an
    order that computes each wire before its use."""
    if k not in NET_BLOCKS:
        raise ValueError(f"median_network: no network for k = {k}")
    bx, by = NET_BLOCKS[k]
    rows, cols = by + k - 1, bx + k - 1
    net = _Builder(rows * cols)
    cache = {}
    col_lists = [_shared([_Sorted(i * cols + j) for i in range(rows)], by, k, cache)
                 for j in range(cols)]
    finals = []
    for t in range(by):
        finals += _shared([col_lists[j][t] for j in range(cols)], bx, k, cache)
    m = k * k // 2
    for f in finals:
        f.demand(m, m)
    # push demands consumers-first (reverse post-order of the list graph)
    seen, post = set(), []

    def visit(s):
        if id(s) not in seen:
            seen.add(id(s))
            for d in s.kids:
                visit(d)
            post.append(s)

    for f in finals:
        visit(f)
    for s in reversed(post):
        s.push_demand()
    outs = [f.build(net)[m] for f in finals]
    # dead-code elimination, then renumbering
    n_in = rows * cols
    live = set(outs)
    for n in range(len(net.ops) - 1, -1, -1):
        if n_in + n in live:
            live.update(net.ops[n][1:])
    keep = [n for n in range(len(net.ops)) if n_in + n in live]
    ren = {w: w for w in range(n_in)}
    ops = []
    for n in keep:
        kind, a, b = net.ops[n]
        ren[n_in + n] = n_in + len(ops)
        ops.append((kind, ren[a], ren[b]))
    outs = [ren[w] for w in outs]
    fused, folded = _fuse3(n_in, ops, outs)
    ren = {w: w for w in range(n_in)}
    final = []
    for n, (kind, a, b, c) in enumerate(fused):
        if n_in + n in folded:
            continue
        ren[n_in + n] = n_in + len(final)
        final.append((kind, ren[a], ren[b], ren[c] if c >= 0 else -1))
    return MedianNetwork(k, bx, by, rows, cols, tuple(final), tuple(ren[w] for w in outs))


def net_tile(k: int) -> dict:
    """The network kernel's tile for window k, as csrc/median.cu's NetTile
    computes it: threads across (tx) and down (ty), rows of a band, staged
    rows and their pitch in words (a thread's row of input words starts
    16-byte aligned), and the shared loads of a thread's row (16-byte ones,
    then an 8- and a 4-byte one for the rest)."""
    net = median_network(k)
    tx = NET_TILE_W // net.bx
    ty = NET_LAUNCH[k][0] // tx
    return dict(tx=tx, ty=ty, band=ty * net.by, srows=ty * net.by + 2 * (k // 2),
                pitch=-(-(NET_TILE_W - net.bx + net.cols) // 4) * 4,
                row_loads=net.cols // 4 + (net.cols % 4 >= 2) + net.cols % 2)


def network_ops_per_px(k: int) -> dict:
    """Instructions a pixel of the network kernel for window k, counted
    from its code: the network's min/max instructions over the LANES pixels
    of a word; its shared loads; staging, a byte_perm and a shared store a
    staged word (two pixels), over the staged tile's share of the outputs;
    and the output, three byte_perm and a store per four pixels of a band.
    "total" is their sum; "comparisons" the two-input min/max a pixel."""
    net = median_network(k)
    t = net_tile(k)
    px = net.bx * net.by * LANES
    out = dict(network=len(net.ops) / px, loads=net.rows * t["row_loads"] / px,
               stage=2 / LANES * t["srows"] * t["pitch"] / (t["band"] * NET_TILE_W),
               store=1.0)
    out["total"] = sum(out.values())
    out["comparisons"] = net.comparisons / (net.bx * net.by)
    return out


@functools.lru_cache(maxsize=1)
def network_header() -> str:
    """The CUDA header of K7's networks (``median_net.h``), which
    ``csrc/median.cu`` includes: for each k a MedianNet<k> with the block
    shape, the CTA's threads and launch bounds (NET_LAUNCH), and
    run<Op>(v, o), the network as straight-line code on words of packed
    lanes (Op::mn, mx, mn3, mx3)."""
    lines = ["// Generated by tpuva_torch/ops/median.py::network_header; do not edit.",
             "#pragma once", "#include <cstdint>", "",
             f"constexpr int kNetTileW = {NET_TILE_W};  // output columns of a CTA, in both bands",
             "", "template <int K> struct MedianNet;"]
    for k in sorted(NET_BLOCKS):
        net = median_network(k)
        n_in = net.rows * net.cols

        def name(w):
            return f"v[{w // net.cols}][{w % net.cols}]" if w < n_in else f"t{w - n_in}"

        threads, min_blocks = NET_LAUNCH[k]
        lines += ["", f"template <> struct MedianNet<{k}> {{",
                  f"  static constexpr int kBX = {net.bx}, kBY = {net.by}, "
                  f"kRows = {net.rows}, kCols = {net.cols}, kOps = {len(net.ops)};",
                  f"  static constexpr int kThreads = {threads}, kMinBlocks = {min_blocks};",
                  "  template <class Op, int P>",
                  "  __device__ __forceinline__ static void run(const uint32_t (&v)[kRows][P],",
                  "                                             uint32_t (&o)[kBY][kBX]) {"]
        for n, (kind, a, b, c) in enumerate(net.ops):
            args = ", ".join(name(w) for w in (a, b, c) if w >= 0)
            lines.append(f"    const uint32_t t{n} = "
                         f"Op::{kind.replace('min', 'mn').replace('max', 'mx')}({args});")
        for i, w in enumerate(net.outputs):
            lines.append(f"    o[{i // net.bx}][{i % net.bx}] = {name(w)};")
        lines += ["  }", "};"]
    return "\n".join(lines) + "\n"


def hist_plan(N: int, H: int, W: int, k: int, sms: int = H100_SMS) -> dict:
    """The histogram tier's launch for N frames of H x W and window k on a
    card of `sms` SMs, as csrc/median.cu's hist_plan computes it: the
    bytes of a count (1 while k*k <= 255, 2 while k*k <= 65535, else 4),
    threads a CTA (a thread a column; 64 with 4-byte counts), the strip's
    rows (8k, so that filling a strip's first window, k*k updates, adds at
    most 1/16 to its 2k a row; fewer where the frames and column blocks
    would leave an SM without a CTA), shared bytes a CTA (256 fine and 16
    coarse bins a thread, then two buffers of the entering and leaving
    rows, columns plus a halo rounded up to 16 bytes each side, and 16
    bytes of slack) and the grid."""
    count_bytes = 1 if k * k <= 255 else 2 if k * k <= 65535 else 4
    threads = 64 if count_bytes == 4 else 128
    cols = -(-W // threads)
    strips = min(H, -(-sms // (cols * min(N, 65535))))
    strip = max(1, min(8 * k, -(-H // strips)))
    r16 = -(-(k // 2) // 16) * 16
    hist_bytes = 272 * 128 * (1 if count_bytes == 1 else 2)
    return dict(count_bytes=count_bytes, threads=threads, strip=strip,
                smem=hist_bytes + 4 * (threads + 2 * r16 + 16), grid=(cols, -(-H // strip), N))


def hist_ops_per_px(k: int) -> dict:
    """Instructions a pixel of the histogram tier for window k, counted
    from csrc/median.cu: 2k updates (k values leave, k enter), each a byte
    permute, a shift-add to its fine count, a shift and a shift-add to its
    coarse count, and two shared atomic adds; for lt and lc, 8 sums of
    absolute byte differences and 4 adds a word of four pixels of each
    row; a shared load and a funnel shift a word of each row; the walk
    (about 4 counts read on natural frames, a compare and add each) and
    the output store. "total" is their sum."""
    words = k // 4 + 1
    out = dict(address=2 * k * 4, atomics=2 * k * 2, sad=12 * words, loads=4 * words,
               walk=8, store=1)
    out["total"] = sum(out.values())
    return out


def _check(x: torch.Tensor, ksize: int, who: str) -> None:
    if x.dim() != 3 or x.dtype != torch.uint8:
        raise ValueError(f"{who}: x must be (N, H, W) uint8")
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"{who}: ksize must be odd and positive, got {ksize}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {x.device}")


def _launch(x: torch.Tensor, ksize: int, entry: str) -> torch.Tensor:
    x = x.contiguous()
    N, H, W = x.shape
    out = torch.empty_like(x)
    _build.launch(x.device, entry, "median_u8 kernel", x.data_ptr(), out.data_ptr(), N, H, W,
                  ksize)
    return out


def median_hist_u8(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """K7's histogram tier for any odd ksize >= 3, the networks' range
    included (the crossover of the two tiers is timed with it); otherwise
    as median_u8. No route calls it."""
    _check(x, ksize, "median_hist_u8")
    if x.device.type == "cpu":
        return median_u8_plain(x, ksize)
    if ksize == 1 or x.numel() == 0:
        return x.clone()
    out = _launch(x, ksize, "tpuva_median_hist_u8")
    median_hist_u8.launches += 1
    return out


median_hist_u8.launches = 0


def median_u8(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.medianBlur of every frame of x (N, H, W) uint8 -> uint8, exact,
    BORDER_REPLICATE; ksize odd and positive (1 is the identity). CUDA
    tensors launch kernel K7 once (its networks below HIST_MIN_K, its
    sliding histogram from there); CPU tensors take median_u8_plain."""
    _check(x, ksize, "median_u8")
    if x.device.type == "cpu":
        return median_u8_plain(x, ksize)
    if ksize == 1 or x.numel() == 0:
        return x.clone()
    out = _launch(x, ksize, "tpuva_median_u8")
    median_u8.launches += 1
    return out


median_u8.launches = 0
