"""K7's histogram tier (csrc/median.cu, median_hist_kernel: k >= 11) as a
numpy model of its algorithm, against the plain versions and tpuva.

The model runs what the kernel runs, column by column: ops/median.py's
hist_plan (strips, count widths), a strip's first window filled row by
row, then a row step that removes the leaving row's k pixels and adds the
entering row's (each removal before its successor's addition), the 256
fine and 16 coarse counts held in the plan's count width, lt and lc moved
by the sums of absolute byte differences of the rows' words (the tail
word's unused bytes zero in both rows), and the bounded walk of the
median. It equals median_u8_plain and tpuva's median_blur at k = 11, 13,
15, 17 and 25 on random frames with a dark half, the adversarial frames,
frames below the window, one row, one column and heights no strip
divides; lt and lc equal direct counts after every row, no count passes
its width, and no walk takes more than 32 moves. median_u8_counts_plain,
the yardstick for large k at 1080p, equals median_u8_plain for k = 3 to 51.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuva.ops.filters as jf
from tpuva_torch.ops import median as tm
from tpuva_torch.scenes import median_adversarial
from test_torch_kernels import one_torch_thread  # noqa: F401

WALK_BOUND = 32


def sad(words, t):
    """Sum of the bytes' distances to t (..., lanes) of words (..., lanes,
    nwords, 4) of bytes: __vsadu4 summed over a row's words."""
    return np.abs(words.astype(np.int64) - t[..., None, None]).sum(axis=(-1, -2))


def row_words(xc, rows, k):
    """The k pixels of each lane's window columns of the given rows as
    words of 4 bytes, the last word's unused bytes zero: (N, S, W, nw, 4)."""
    v = xc[:, rows]  # (N, S, W, k)
    nw = -(-k // 4)
    pad = np.zeros(v.shape[:-1] + (4 * nw - k,), v.dtype)
    return np.concatenate([v, pad], axis=-1).reshape(v.shape[:-1] + (nw, 4))


def walk(fine, coarse, st, rank, moves):
    """The kernel's walk (Window::walk) on every lane at once: m to the
    least value with #(< m) <= rank < #(<= m), inside its coarse block bin
    by bin, else block by block, then bin by bin from the block's start.
    moves counts each lane's steps of c and of m."""
    m, c, lt, lc = st
    F = lambda b: np.take_along_axis(fine, b[..., None], -1)[..., 0]  # noqa: E731
    Cc = lambda b: np.take_along_axis(coarse, b[..., None], -1)[..., 0]  # noqa: E731
    down = lt > rank
    far = down & (lc > rank)
    act = far.copy()
    while act.any():
        c[act] -= 1
        lc[act] -= Cc(c)[act]
        moves[act] += 1
        act &= lc > rank
    m[far], lt[far] = 16 * c[far], lc[far]
    act = down & ~far
    while act.any():
        m[act] -= 1
        lt[act] -= F(m)[act]
        moves[act] += 1
        act &= lt > rank
    h = F(m)
    up = ~down & (lt + h <= rank)
    hc = lc + Cc(c)
    ufar = up & (hc <= rank)
    lc[ufar], c[ufar] = hc[ufar], c[ufar] + 1
    moves[ufar] += 1
    act = ufar.copy()
    while act.any():
        act &= lc + Cc(np.minimum(c, 15)) <= rank
        lc[act] += Cc(c)[act]
        c[act] += 1
        moves[act] += 1
    m[ufar], lt[ufar] = 16 * c[ufar], lc[ufar]
    near = up & ~ufar
    lt[near] += h[near]
    m[near] += 1
    moves[near] += 1
    act = far | up
    while act.any():
        act &= lt + F(m) <= rank
        lt[act] += F(m)[act]
        m[act] += 1
        moves[act] += 1


def hist_model(x, k, strip=None):
    """K7's histogram tier on frames x (N, H, W) uint8, every strip of
    every frame's columns as one lane, the strips side by side. strip
    overrides hist_plan's rows. Returns (medians, stats): the strip, the
    count width, the largest count seen and the most walk moves of a
    row."""
    N, H, W = x.shape
    plan = tm.hist_plan(N, H, W, k)
    S = strip or plan["strip"]
    cap = (1 << (8 * plan["count_bytes"])) - 1
    r, rank = k // 2, k * k // 2
    xc = x[:, :, np.clip(np.arange(W)[:, None] + np.arange(-r, r + 1), 0, W - 1)]  # (N,H,W,k)
    y0 = np.arange(0, H, S)
    lanes = (N, len(y0), W)
    nn, ss, ww = np.indices(lanes)
    fine = np.zeros(lanes + (256,), np.int64)
    coarse = np.zeros(lanes + (16,), np.int64)
    m, c, lt, lc = (np.zeros(lanes, np.int64) for _ in range(4))
    out = np.zeros_like(x)
    moves_max, count_max = 0, 0
    for i in range(k + S - 1):
        add = row_words(xc, np.clip(y0 - r + i, 0, H - 1), k)
        leave = row_words(xc, np.clip(y0 - r + i - k, 0, H - 1), k)
        remove = i >= k
        for j in range(k):
            for words, d in ((leave, -1), (add, 1)) if remove else ((add, 1),):
                p = words[..., j // 4, j % 4].astype(np.int64)
                fine[nn, ss, ww, p] += d
                coarse[nn, ss, ww, p >> 4] += d
                f, g = fine[nn, ss, ww, p], coarse[nn, ss, ww, p >> 4]
                assert d > 0 or (f.min() >= 0 and g.min() >= 0)
                count_max = max(count_max, int(g.max()))  # a coarse count holds its fine ones
        if remove:  # lt and lc by the SADs at m, m - 1, 16c, 16c - 1
            for cnt, t in ((lt, m), (lc, 16 * c)):
                tp = np.maximum(t - 1, 0)
                up = sad(add, t) + sad(leave, tp)
                down = sad(add, tp) + sad(leave, t)
                cnt += (up - down) // 2
        direct = np.cumsum(fine, -1)
        np.testing.assert_array_equal(lt, np.where(m > 0, np.take_along_axis(
            direct, np.maximum(m - 1, 0)[..., None], -1)[..., 0], 0))
        np.testing.assert_array_equal(lc, np.where(c > 0, np.take_along_axis(
            direct, np.maximum(16 * c - 1, 0)[..., None], -1)[..., 0], 0))
        if i >= k - 1:
            moves = np.zeros(lanes, np.int64)
            walk(fine, coarse, (m, c, lt, lc), rank, moves)
            moves_max = max(moves_max, int(moves.max()))
            y = y0 + i - k + 1
            ok = y < np.minimum(y0 + S, H)
            out[:, y[ok]] = m[:, ok].astype(np.uint8)
    assert count_max <= cap
    return out, dict(strip=S, cap=cap, count_max=count_max, moves_max=moves_max)


def frames_cases(k):
    """(name, frames, strip) for the model: random frames with a dark half
    and the adversarial ones, 45 rows (no multiple of 7 or 16) in the
    plan's strips and in 7- and 16-row strips; frames below the
    window, one row, one column in the plan's."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 256, (2, 45, 70), dtype=np.uint8)
    x[:, :22] //= 8
    x = np.concatenate([x, *median_adversarial((1, 45, 70), seed=k).values()])
    cases = [(f"dark half and adversarial, strips of {s}", x, s) for s in (None, 7, 16)]
    for shape in ((1, 5, 7), (2, 1, 50), (2, 50, 1)):
        cases.append((f"{shape}", rng.integers(0, 256, shape, dtype=np.uint8), None))
    return cases


@pytest.mark.parametrize("ksize", [11, 13, 15, 17, 25])
def test_hist_model_matches_plain_and_tpuva(ksize):
    """The model of K7's histogram tier equals median_u8_plain and tpuva's
    median_blur on every frames_cases frame; no count passes its width."""
    refs = {}
    for name, x, strip in frames_cases(ksize):
        got, stats = hist_model(x, ksize, strip)
        if id(x) not in refs:
            refs[id(x)] = np.asarray(jf.median_blur(jnp.asarray(x), ksize))
        np.testing.assert_array_equal(got, refs[id(x)], err_msg=name)
        np.testing.assert_array_equal(got, tm.median_u8_plain(torch.from_numpy(x), ksize).numpy(),
                                      err_msg=name)
        assert stats["count_max"] <= stats["cap"]


@pytest.mark.parametrize("ksize", [11, 15, 25])
def test_hist_walk_bounded_on_adversarial(ksize):
    """No walk of the median takes more than 32 moves on the adversarial
    frames (0/255 moves the median by 255 in a row), and those frames do
    make walks that cross coarse blocks (more than 16 moves)."""
    most = 0
    for name, x in median_adversarial((2, 48, 40), seed=ksize).items():
        _out, stats = hist_model(x, ksize, strip=24)
        assert stats["moves_max"] <= WALK_BOUND, name
        most = max(most, stats["moves_max"])
    assert most > 16


def test_hist_count_width_holds_k2():
    """hist_plan's count width for each odd k holds k*k (a count never
    passes the window's pixels) and is the narrowest that does: 1 byte to
    k = 15, 2 to 255, 4 past that; 64 threads a CTA with 4-byte counts."""
    for k in list(range(3, 601, 2)) + [40001]:
        plan = tm.hist_plan(1, 1080, 1920, k)
        b = plan["count_bytes"]
        assert k * k < 1 << (8 * b)
        assert b == 1 or k * k >= 1 << (8 * (b // 2))
        assert plan["threads"] == (64 if b == 4 else 128)
    assert [tm.hist_plan(1, 8, 8, k)["count_bytes"] for k in (15, 17, 255, 257)] == [1, 2, 2, 4]


def test_hist_plan_fills_the_card():
    """At 1080p a 256-frame batch takes 8k-row strips (the first window's
    k*k updates add 1/16 to a strip's 2k a row) and one frame still gives
    every one of 132 SMs a CTA; shared memory stays in a CTA's 227 KB to k =
    40001, six CTAs an SM with 1-byte counts and three with 2-byte ones;
    4-byte counts take 64 columns a CTA."""
    for k in (11, 15, 21, 51):
        plan = tm.hist_plan(256, 1080, 1920, k)
        assert plan["strip"] == 8 * k and plan["grid"] == (15, -(-1080 // (8 * k)), 256)
        cols, strips, n = tm.hist_plan(1, 1080, 1920, k)["grid"]
        assert cols * strips * n >= 132
    for k in (255, 257, 437, 40001):
        cols, strips, n = tm.hist_plan(1, 1080, 1920, k)["grid"]
        assert cols * strips * n >= 132 and tm.hist_plan(1, 1080, 1920, k)["smem"] <= 227 * 1024
    sm = 228 * 1024
    assert sm // (tm.hist_plan(256, 1080, 1920, 15)["smem"] + 1024) == 6
    assert sm // (tm.hist_plan(256, 1080, 1920, 21)["smem"] + 1024) == 3
    assert tm.hist_plan(256, 1080, 1920, 257)["grid"][0] == 30


def test_sad_counts_bytes_below():
    """The identity the kernel's lt and lc rest on: a word's bytes below t
    number (SAD(v, t) - SAD(v, t - 1) + 4) / 2, and 0 at t = 0 with t - 1
    taken as 0."""
    rng = np.random.default_rng(5)
    v = rng.integers(0, 256, (2000, 1, 4)).astype(np.int64)
    v[:500] = rng.choice([0, 255, 17], (500, 1, 4))
    for t in range(256):
        tt = np.full(v.shape[0], t)
        got = (sad(v, tt) - sad(v, np.maximum(tt - 1, 0)) + (4 if t else 0)) // 2
        np.testing.assert_array_equal(got, (v[:, 0] < t).sum(-1))


@pytest.mark.parametrize("ksize", range(3, 52, 2))
def test_median_u8_counts_plain_matches_sort(ksize):
    """median_u8_counts_plain, K7's yardstick at large k (its memory does
    not grow with k), equals median_u8_plain on random bytes with a dark
    half, frames below the window, one row and one column."""
    rng = np.random.default_rng(ksize)
    for shape in ((2, 23, 31), (1, 1, 40), (1, 40, 1), (2, 4, 5)):
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        x[:, : shape[1] // 2] //= 8
        t = torch.from_numpy(x)
        assert torch.equal(tm.median_u8_counts_plain(t, ksize), tm.median_u8_plain(t, ksize))
