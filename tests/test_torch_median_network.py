"""K7's selection networks (``tpuva_torch/ops/median.py::median_network``),
the schedule that ``csrc/median.cu`` runs for k = 3, 5, 7 and 9, on the CPU.

- Each network is a min/max circuit, so by the 0-1 principle it selects
  rank k*k // 2 of every window if and only if it does for every window
  of 0s and 1s. Every output's inputs lie in its own window (checked on
  the op list), so that proves it: k = 3 and k = 5 exhaustively (all 2^9
  and 2^25 windows of each output of the block, 64 windows a 64-bit word,
  the block's other inputs held at 0, then at 1); k = 7 and 9 on random
  and tie-heavy windows against a sort.
- The tile-level model (``median_u8_model`` below: blocks of outputs over
  clamped windows, the ragged right and bottom blocks included) equals
  ``median_u8_plain`` and tpuva's ``median_blur`` (JAX CPU backend) on
  frames of widths 1, 2, 3, 5 and 37, H or W below the window, and one row.
- The generated header holds the same op list, op for op.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuva.ops.filters as jf
from tpuva_torch import _build
from tpuva_torch.ops import median as tm
from tpuva_torch.ops.filters import median_u8_plain
from tpuva_torch.scenes import median_adversarial
from test_torch_kernels import one_torch_thread  # noqa: F401

KS = sorted(tm.NET_BLOCKS)


def run_network(net, v):
    """Evaluate net on its rows * cols input tensors v, op by op as the
    kernel does; returns the by * bx outputs (row major)."""
    w = list(v)
    for kind, a, b, c in net.ops:
        f = torch.minimum if kind.startswith("min") else torch.maximum
        r = f(w[a], w[b])
        w.append(f(r, w[c]) if c >= 0 else r)
    return [w[o] for o in net.outputs]


def median_u8_model(x, ksize):
    """What K7's network tier computes, on the CPU: the frames of x (N, H,
    W) cut into blocks of BX x BY outputs, each block's input window read
    with its indices clamped into the frame (BORDER_REPLICATE, the ragged
    right and bottom blocks included), median_network(ksize) run on every
    block at once, and the outputs inside the frame kept."""
    net = tm.median_network(ksize)
    N, H, W = x.shape
    r = ksize // 2
    nby, nbx = -(-H // net.by), -(-W // net.bx)
    ys = torch.arange(nby)[:, None] * net.by - r + torch.arange(net.rows)[None]
    xs = torch.arange(nbx)[:, None] * net.bx - r + torch.arange(net.cols)[None]
    ys, xs = ys.clamp(0, H - 1), xs.clamp(0, W - 1)
    # win[n, block row, row i, block column, column j]
    win = x[:, ys][:, :, :, xs]
    v = [win[:, :, i, :, j] for i in range(net.rows) for j in range(net.cols)]
    outs = run_network(net, v)
    blocks = torch.stack(outs, dim=-1).reshape(N, nby, nbx, net.by, net.bx)
    out = blocks.permute(0, 1, 3, 2, 4).reshape(N, nby * net.by, nbx * net.bx)
    return out[:, :H, :W].contiguous()


def cone(net, out):
    """(the ops that output wire `out` depends on, in order; its inputs)."""
    n_in = net.rows * net.cols
    need = {out}
    for n in range(len(net.ops) - 1, -1, -1):
        if n_in + n in need:
            need.update(w for w in net.ops[n][1:] if w >= 0)
    return ([n for n in range(len(net.ops)) if n_in + n in need],
            sorted(w for w in need if w < n_in))


def run_cone(net, ops, values):
    """Evaluate ops of net on {wire: value}, AND for min and OR for max (a
    min/max on 0/1 bits, many windows a word); returns values."""
    n_in = net.rows * net.cols
    for n in ops:
        kind, a, b, c = net.ops[n]
        f = torch.bitwise_and if kind.startswith("min") else torch.bitwise_or
        r = f(values[a], values[b])
        values[n_in + n] = f(r, values[c]) if c >= 0 else r
    return values


def window(net, t, x):
    """Input wires of output (row t, column x): rows t..t+k-1, columns
    x..x+k-1 of the block, in row-major order."""
    return [(t + i) * net.cols + x + j for i in range(net.k) for j in range(net.k)]


@pytest.mark.parametrize("k", KS)
def test_network_shape(k):
    """Ops read only earlier wires; every output's inputs are its window
    and nothing else (so the 0-1 checks below cover every input), the
    block's outputs in row-major order; the counts are the ones the
    kernel's note and PERF.md state."""
    net = tm.median_network(k)
    n_in = net.rows * net.cols
    assert (net.bx, net.by) == tm.NET_BLOCKS[k]
    assert (net.rows, net.cols) == (net.by + k - 1, net.bx + k - 1)
    for n, (kind, a, b, c) in enumerate(net.ops):
        assert kind in ("min", "max", "min3", "max3") and (c >= 0) == kind.endswith("3")
        assert all(w < n_in + n for w in (a, b, c))
    assert len(net.outputs) == net.bx * net.by
    for t in range(net.by):
        for x in range(net.bx):
            assert cone(net, net.outputs[t * net.bx + x])[1] == sorted(window(net, t, x))
    assert net.comparisons / (net.bx * net.by) < {3: 18, 5: 64, 7: 149, 9: 331}[k]


def bit_patterns(n):
    """The 2^n windows of n bits as int64 words of 64 windows: input e's
    word w holds bit e of window 64 w + b in its bit b; and the median of
    each window (1 iff at least n // 2 + 1 ones) the same way; n >= 6."""
    words = (1 << n) // 64
    b = np.arange(64, dtype=np.uint64)
    w = np.arange(words, dtype=np.uint64)
    inputs = []
    for e in range(n):
        if e < 6:
            word = np.uint64(0)
            for bit in b[((b >> np.uint64(e)) & np.uint64(1)).astype(bool)]:
                word |= np.uint64(1) << bit
            inputs.append(np.full(words, word, np.uint64))
        else:
            inputs.append(np.where((w >> np.uint64(e - 6)) & np.uint64(1), ~np.uint64(0),
                                   np.uint64(0)))
    # ones in window 64 w + b: popcount(w) + popcount(b)
    pc_b = np.array([bin(i).count("1") for i in range(64)])
    masks = [np.uint64(sum(1 << i for i in range(64) if pc_b[i] >= t)) for t in range(8)]
    pc_w = np.unpackbits(w.view(np.uint8).reshape(-1, 8), axis=1).sum(1).astype(np.int64)
    expect = np.array(masks, np.uint64)[np.clip(n // 2 + 1 - pc_w, 0, 7)]
    as_t = lambda a: torch.from_numpy(a.view(np.int64))  # noqa: E731
    return [as_t(x) for x in inputs], as_t(expect)


@pytest.mark.parametrize("k", [3, 5])
def test_network_selects_the_median_of_every_01_window(k):
    """The 0-1 principle, exhaustively: for each output of the block, all
    2^(k*k) windows of 0s and 1s, the other inputs held at 0 and then at 1,
    give the window's median (in chunks of 2^21 windows, which stay in the
    cache)."""
    net = tm.median_network(k)
    pats, expect = bit_patterns(k * k)
    chunk = 1 << 15
    held = {v: torch.full((chunk,), v, dtype=torch.int64) for v in (0, -1)}
    for t in range(net.by):
        for x in range(net.bx):
            out = net.outputs[t * net.bx + x]
            ops, _ = cone(net, out)
            win = window(net, t, x)
            for outside in (0, -1):
                for s in range(0, expect.numel(), chunk):
                    part = expect[s:s + chunk]
                    values = dict.fromkeys(range(net.rows * net.cols), held[outside][:part.numel()])
                    values.update((w, p[s:s + chunk]) for w, p in zip(win, pats))
                    got = run_cone(net, ops, values)[out]
                    assert torch.equal(got, part), (k, t, x, outside, s)


def tie_heavy_windows(k, n, rng):
    """n windows of k*k bytes: random, two values, three values, constant,
    and ramps (rising, falling, with a step)."""
    kk = k * k
    ramp = np.arange(kk)
    parts = [
        rng.integers(0, 256, (n, kk)),
        rng.choice([3, 250], (n, kk)),
        rng.choice([0, 128, 255], (n, kk)),
        np.broadcast_to(rng.integers(0, 256, (n, 1)), (n, kk)),
        (ramp[None] * rng.integers(1, 4, (n, 1)) + rng.integers(0, 40, (n, 1))) % 256,
        255 - (ramp[None] + rng.integers(0, 200, (n, 1))) % 256,
        np.where(ramp[None] < rng.integers(0, kk, (n, 1)), 0, 255),
    ]
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("k", KS)
def test_network_matches_a_sort_on_random_and_tied_windows(k):
    """Every output of the block on random and tie-heavy windows equals
    the middle element of its sorted window."""
    net = tm.median_network(k)
    rng = np.random.default_rng(k)
    for t in range(net.by):
        for x in range(net.bx):
            wins = tie_heavy_windows(k, 300, rng)
            n = wins.shape[0]
            block = rng.integers(0, 256, (n, net.rows * net.cols)).astype(np.int32)
            block[:, window(net, t, x)] = wins
            v = [torch.from_numpy(block[:, i]) for i in range(block.shape[1])]
            got = run_network(net, v)[t * net.bx + x]
            ref = np.sort(wins, axis=1)[:, k * k // 2]
            np.testing.assert_array_equal(got.numpy(), ref)


# widths 1, 2, 3, 5, 37 (none a multiple of the 8 columns of a block, 37
# one past 36), 9 rows (4 blocks and a half), H and W below the window, one
# row; a shape is one compile for tpuva's median_blur, ~0.5 s
MODEL_SHAPES = [(2, 9, 1), (2, 9, 2), (2, 9, 3), (2, 9, 5), (2, 9, 37), (2, 4, 5), (1, 1, 37)]


@pytest.mark.parametrize("k", KS)
def test_model_matches_plain_and_tpuva(k):
    """The tile-level model of the kernel (blocks over clamped windows)
    equals median_u8_plain and tpuva's median_blur on random bytes with a
    dark half (many equal values in a window) and the adversarial frames,
    stacked into one batch a shape: ragged widths, H or W below the window,
    one row."""
    rng = np.random.default_rng(100 + k)
    for shape in MODEL_SHAPES:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        x[:, : shape[1] // 2] //= 8
        f = np.concatenate([x] + list(median_adversarial(shape, seed=k).values()))
        got = median_u8_model(torch.from_numpy(f), k).numpy()
        np.testing.assert_array_equal(got, median_u8_plain(torch.from_numpy(f), k).numpy())
        np.testing.assert_array_equal(got, np.asarray(jf.median_blur(jnp.asarray(f), k)))


def test_header_holds_the_network():
    """network_header(), which the build writes beside csrc/median.cu,
    runs each MedianNet<k> op for op as median_network(k) lists it, with
    its block shape and launch, and the build writes that text."""
    text = tm.network_header()
    assert _build.generated_headers() == {"median_net.h": text}
    for k in KS:
        net = tm.median_network(k)
        body = text.split(f"struct MedianNet<{k}> {{")[1].split("\n};")[0]
        shape = re.search(r"kBX = (\d+), kBY = (\d+), kRows = (\d+), kCols = (\d+), kOps = (\d+);"
                          r"\s+static constexpr int kThreads = (\d+), kMinBlocks = (\d+);", body)
        assert tuple(map(int, shape.groups())) == (net.bx, net.by, net.rows, net.cols, len(net.ops),
                                                   *tm.NET_LAUNCH[k])
        n_in = net.rows * net.cols

        def wire(name):
            m = re.fullmatch(r"v\[(\d+)\]\[(\d+)\]", name)
            return int(m[1]) * net.cols + int(m[2]) if m else n_in + int(name[1:])

        ops = []
        for n, (kind, args) in enumerate(re.findall(r"const uint32_t t\d+ = Op::(\w+)\(([^)]*)\);",
                                                    body)):
            ws = [wire(a.strip()) for a in args.split(",")]
            ops.append((kind.replace("mn", "min").replace("mx", "max"), ws[0], ws[1],
                        ws[2] if len(ws) == 3 else -1))
        assert tuple(ops) == net.ops
        outs = re.findall(r"o\[(\d+)\]\[(\d+)\] = (\S+);", body)
        assert [wire(w) for _t, _x, w in outs] == list(net.outputs)
        assert [int(t) * net.bx + int(x) for t, x, _w in outs] == list(range(net.bx * net.by))


@pytest.mark.parametrize("k", KS)
def test_ops_per_px_counts_the_kernel(k):
    """network_ops_per_px: the network's instructions over the lanes, and
    the tile csrc/median.cu derives (every staged row holds the halo)."""
    net = tm.median_network(k)
    t = tm.net_tile(k)
    ops = tm.network_ops_per_px(k)
    assert ops["network"] == len(net.ops) / (net.bx * net.by * tm.LANES)
    assert ops["total"] == pytest.approx(sum(v for n, v in ops.items()
                                             if n not in ("total", "comparisons")))
    assert t["tx"] * t["ty"] == tm.NET_LAUNCH[k][0] and t["tx"] * net.bx == tm.NET_TILE_W
    assert t["pitch"] >= tm.NET_TILE_W + 2 * (k // 2) and t["pitch"] % 4 == 0
